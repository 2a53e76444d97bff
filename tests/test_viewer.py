"""Interactive viewer logic (render/viewer.py vs MiroWindow.cpp),
driven headless — no matplotlib window needed."""

import numpy as np

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.ops.accel import attach_accel
from cse168_raytracer.render.viewer import InteractiveViewer
from cse168_raytracer.scenes import build


def _viewer():
    cfg = RenderConfig(width=32, height=32, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg)
    scene = attach_accel(scene)
    return InteractiveViewer(scene, static, cam, cfg)


def test_keys_move_camera_like_miro():
    """MiroWindow::keyboard camera moves (MiroWindow.cpp:214-245)."""
    v = _viewer()
    eye0 = np.asarray(v.state.cam.eye)
    vd = np.asarray(v.state.cam.view_dir)

    assert v.handle_key("w")
    np.testing.assert_allclose(np.asarray(v.state.cam.eye), eye0 + vd,
                               atol=1e-6)
    assert v.handle_key("s")
    np.testing.assert_allclose(np.asarray(v.state.cam.eye), eye0, atol=1e-6)

    v.handle_key("+")   # m_scaleFact *= 1.5
    v.handle_key("w")
    np.testing.assert_allclose(np.asarray(v.state.cam.eye), eye0 + 1.5 * vd,
                               atol=1e-6)

    up = np.asarray(v.state.cam.up)
    right = np.cross(vd, up)
    eye1 = np.asarray(v.state.cam.eye)
    v.handle_key("d")
    np.testing.assert_allclose(np.asarray(v.state.cam.eye),
                               eye1 + 1.5 * right, atol=1e-5)

    assert not v.handle_key("escape")


def test_drag_orbit_preserves_unit_view_dir():
    """MiroWindow::motion orbit (MiroWindow.cpp:91-115)."""
    v = _viewer()
    vd0 = np.asarray(v.state.cam.view_dir)
    v.handle_drag(30.0, -12.0)
    vd1 = np.asarray(v.state.cam.view_dir)
    assert abs(np.linalg.norm(vd1) - 1.0) < 1e-5
    assert not np.allclose(vd0, vd1)
    # 42-degree total drag: direction moved but not flipped
    assert float(vd0 @ vd1) > 0.5


def test_preview_and_raytrace_frames():
    """Camera::click mode dispatch (Camera.cpp:37-70): both renderers
    produce full-size uint8 frames; 'i' dumps a PPM."""
    import os
    import tempfile
    v = _viewer()
    f_preview = v.render_frame()
    assert f_preview.shape == (32, 32, 3) and f_preview.dtype == np.uint8
    v.handle_key("r")
    f_full = v.render_frame()
    assert f_full.shape == (32, 32, 3)
    assert f_full.any()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            v.handle_key("i")
            dumps = [p for p in os.listdir(".") if p.endswith(".ppm")]
            assert len(dumps) == 1
        finally:
            os.chdir(cwd)
