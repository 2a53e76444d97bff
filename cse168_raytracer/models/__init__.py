from cse168_raytracer.models.obj import load_obj  # noqa: F401
from cse168_raytracer.models.geometry import (  # noqa: F401
    Mesh, TrianglePack, SpherePool, PlanePool, pack_triangles,
)
