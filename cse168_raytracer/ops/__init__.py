from cse168_raytracer.ops.intersect import (  # noqa: F401
    Hit, PRIM_NONE, PRIM_TRI, PRIM_SPHERE, PRIM_PLANE,
    intersect_triangles, intersect_spheres, intersect_planes, closest_hit,
)
