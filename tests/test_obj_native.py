"""Native C++ OBJ loader parity vs the pure-python reference path."""

import numpy as np
import pytest

import cse168_raytracer.models.obj as O


@pytest.fixture()
def restore_native():
    saved = O._NATIVE
    yield
    O._NATIVE = saved


def _compare(path, ctm=None):
    O._NATIVE = None
    lib = O._load_native()
    if lib is None:
        pytest.skip("native loader unavailable (no g++?)")
    nat = O.load_obj(path, ctm)
    O._NATIVE = False
    py = O.load_obj(path, ctm)
    for k in nat:
        assert nat[k].shape == py[k].shape, k
        if nat[k].dtype.kind == "f":
            np.testing.assert_allclose(nat[k], py[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(nat[k], py[k], err_msg=k)
    return nat


def _write_obj(path, mesh, with_normals=True):
    """Write a mesh dict as OBJ text: `v`, optionally `vn`, and 1-based
    faces (`f a//n ...` with normals, `f a b c` without)."""
    lines = [f"v {x:.7g} {y:.7g} {z:.7g}" for x, y, z in mesh["vertices"]]
    if with_normals:
        lines += [f"vn {x:.7g} {y:.7g} {z:.7g}"
                  for x, y, z in mesh["normals"]]
        lines += ["f " + " ".join(f"{v + 1}//{n + 1}" for v, n in zip(fv, fn))
                  for fv, fn in zip(mesh["tri_vidx"], mesh["tri_nidx"])]
    else:
        lines += ["f " + " ".join(str(v + 1) for v in fv)
                  for fv in mesh["tri_vidx"]]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture()
def knot_obj(tmp_path):
    from cse168_raytracer.scenes.registry import torus_knot
    return _write_obj(tmp_path / "knot.obj", torus_knot())


def test_native_teapot_parity(restore_native, knot_obj):
    """Parse parity on a 3,072-face smooth mesh with `vn` normals."""
    out = _compare(knot_obj)
    assert out["tri_vidx"].shape[0] == 3072          # knot face count


def test_native_ctm_parity(restore_native, knot_obj):
    from cse168_raytracer.scenes.registry import (rotate, scale,
                                                  translate)
    ctm = translate(1, 2, 3) @ rotate(25, 0.3, 0.1, 0.6) @ scale(0.5, 2, 1)
    _compare(knot_obj, ctm)


def test_native_generated_normals_parity(restore_native, tmp_path):
    """Faces without vn entries exercise the generated-normal averaging
    path (TriangleMeshLoad.cpp:252-308), as the cornell boxes do."""
    from cse168_raytracer.scenes.registry import quad_grid
    path = _write_obj(tmp_path / "wall.obj",
                      quad_grid((0, 0, 0), (2, 0, 1), (0, 1, 0.5), 6, 5),
                      with_normals=False)
    out = _compare(path)
    n = out["normals"]
    lens = np.linalg.norm(n, axis=1)
    assert np.allclose(lens[lens > 0], 1.0, atol=1e-5)
