"""Declarative scene builders replicating the reference's hard-coded
scenes (main.cpp, assignment1/2/3.cpp). `build(name)` returns
(Scene, SceneStatic, Camera, RenderConfig)."""

from cse168_raytracer.scenes.registry import SCENES, build  # noqa: F401
