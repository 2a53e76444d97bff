from cse168_raytracer.core import vecmath, sampling, noise  # noqa: F401
