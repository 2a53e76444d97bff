"""Interactive viewer: the accelerator-side replacement for the GLUT window
(MiroWindow.{h,cpp}) and the OpenGL wireframe preview (Scene::openGL,
Scene.cpp:36-48).

The reference's interactive loop toggles between a rasterized GL
preview and a full raytrace (Camera::click, Camera.cpp:37-70). There
is no rasterizer here — the "preview" mode is a fast low-spec render
(quarter resolution, depth 1, shadows off) that compiles once and
re-executes per camera move; "raytrace" mode runs the configured
render.

Controls replicate MiroWindow::keyboard/motion (MiroWindow.cpp:91-245):

  left-drag   orbit: rotate viewDir about camera-right and up
              (ANGFACT=1 deg/pixel, MiroWindow.cpp:12,98-108)
  w / s       dolly along viewDir            (MiroWindow.cpp:222-231)
  a / d       truck along right = viewDir x up (MiroWindow.cpp:233-245)
  q / z       pedestal along up              (MiroWindow.cpp:234-243 'q'/'z')
  + / -       move-speed scale x1.5 / /1.5   (MiroWindow.cpp:214-220)
  r / g       raytrace mode / preview mode   (MiroWindow.cpp:204-212)
  i           dump current frame to miro_<time>.ppm (MiroWindow.cpp:160-177)
  m           print eye / look-at            (MiroWindow.cpp:246-252)
  escape      quit                           (MiroWindow.cpp:156-158)

Matplotlib is the window system (the SURVEY-sanctioned replacement for
GLUT); it is imported lazily so headless/batch use of the package
never requires it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.core.vecmath import (cross, rotate_about_axis,
                                           safe_normalize)
from cse168_raytracer.render.camera import Camera
from cse168_raytracer.render.image_io import write_ppm
from cse168_raytracer.render.tonemap import to_bytes, tonemap

ANGFACT = 1.0          # degrees per pixel of mouse drag (MiroWindow.cpp:12)
PREVIEW_SCALE = 4      # preview renders at width/4 x height/4


@dataclasses.dataclass
class ViewerState:
    """Mutable interaction state (m_scaleFact etc., MiroWindow.h)."""
    cam: Camera
    raytrace: bool = False       # False = preview mode (GL-analog)
    scale_fact: float = 1.0      # m_scaleFact
    mouse_xy: Optional[tuple[float, float]] = None
    frame: Optional[np.ndarray] = None   # last tonemapped uint8 frame


class InteractiveViewer:
    """Camera::click + MiroWindow event loop over a jitted renderer."""

    def __init__(self, scene, static, cam: Camera, cfg: RenderConfig,
                 seed: int = 0, tonemap_kind: str = "sigmoid"):
        self.scene = scene
        self.static = static
        self.cfg = cfg
        self.tonemap_kind = tonemap_kind
        self.state = ViewerState(cam=cam)
        self._key = jax.random.key(seed)
        self._render_full = self._make_render(cfg)
        pcfg = dataclasses.replace(
            cfg, width=max(cfg.width // PREVIEW_SCALE, 16),
            height=max(cfg.height // PREVIEW_SCALE, 16),
            trace_depth=1, trace_samples=1, path_tracing=False,
            disable_shadows=True)
        self._render_preview = self._make_render(pcfg)

    def _make_render(self, cfg: RenderConfig):
        from cse168_raytracer.render.integrator import render_hdr

        @jax.jit
        def run(scene, cam, key):
            hdr, _stats = render_hdr(scene, self.static, cam, cfg, key)
            return to_bytes(tonemap(hdr, self.tonemap_kind))

        return run

    def render_frame(self) -> np.ndarray:
        """One frame at the current camera; uint8 (H, W, 3)."""
        run = (self._render_full if self.state.raytrace
               else self._render_preview)
        rgb8 = np.asarray(run(self.scene, self.state.cam, self._key))
        if not self.state.raytrace and rgb8.shape[0] != self.cfg.height:
            rgb8 = np.repeat(np.repeat(rgb8, PREVIEW_SCALE, 0),
                             PREVIEW_SCALE, 1)
            rgb8 = rgb8[:self.cfg.height, :self.cfg.width]
        self.state.frame = rgb8
        return rgb8

    # -- MiroWindow::keyboard (MiroWindow.cpp:152-245) ---------------------
    def handle_key(self, key: str) -> bool:
        """Apply one key; returns False on quit."""
        st = self.state
        cam = st.cam
        # reference leaves vRight unnormalized (MiroWindow.cpp:233-245)
        right = cross(cam.view_dir, cam.up)
        if key in ("escape", "esc"):
            return False
        elif key in ("i", "I"):
            if st.frame is None:
                self.render_frame()
            write_ppm(f"miro_{int(time.time())}.ppm", st.frame)
        elif key in ("r", "R"):
            st.raytrace = True
        elif key in ("g", "G"):
            st.raytrace = False
        elif key == "+":
            st.scale_fact *= 1.5
        elif key == "-":
            st.scale_fact /= 1.5
        elif key in ("w", "W"):
            st.cam = cam.replace(eye=cam.eye + st.scale_fact * cam.view_dir)
        elif key in ("s", "S"):
            st.cam = cam.replace(eye=cam.eye - st.scale_fact * cam.view_dir)
        elif key in ("q", "Q"):
            st.cam = cam.replace(eye=cam.eye + st.scale_fact * cam.up)
        elif key in ("z", "Z"):
            st.cam = cam.replace(eye=cam.eye - st.scale_fact * cam.up)
        elif key in ("a", "A"):
            st.cam = cam.replace(eye=cam.eye - st.scale_fact * right)
        elif key in ("d", "D"):
            st.cam = cam.replace(eye=cam.eye + st.scale_fact * right)
        elif key in ("m", "M"):
            print(f"Eye: {np.asarray(st.cam.eye)}")
            print(f"ViewDir: {np.asarray(st.cam.view_dir)}")
        return True

    # -- MiroWindow::motion (MiroWindow.cpp:91-115) -------------------------
    def handle_drag(self, dx: float, dy: float) -> None:
        """Left-button orbit: rotate viewDir about right then up."""
        st = self.state
        cam = st.cam
        xfact = -ANGFACT * dy * np.pi / 180.0
        yfact = -ANGFACT * dx * np.pi / 180.0
        right = cross(cam.view_dir, cam.up)
        v = rotate_about_axis(cam.view_dir, xfact, right)
        v = rotate_about_axis(v, yfact, cam.up)
        st.cam = cam.replace(view_dir=safe_normalize(v))

    # -- MiroWindow::mainLoop (MiroWindow.cpp:63-78) ------------------------
    def main_loop(self) -> None:
        """Open a matplotlib window and run the event loop."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8 * self.cfg.height
                                        / max(self.cfg.width, 1)))
        ax.set_axis_off()
        im = ax.imshow(self.render_frame())
        fig.canvas.manager.set_window_title("miro")

        def redraw():
            im.set_data(self.render_frame())
            fig.canvas.draw_idle()

        def on_key(event):
            if event.key is None:
                return
            if not self.handle_key(event.key):
                plt.close(fig)
                return
            redraw()

        def on_press(event):
            if event.button == 1:
                self.state.mouse_xy = (event.x, event.y)

        def on_release(event):
            self.state.mouse_xy = None

        def on_motion(event):
            if self.state.mouse_xy is None or event.x is None:
                return
            x0, y0 = self.state.mouse_xy
            self.handle_drag(event.x - x0, -(event.y - y0))
            self.state.mouse_xy = (event.x, event.y)
            redraw()

        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect("button_press_event", on_press)
        fig.canvas.mpl_connect("button_release_event", on_release)
        fig.canvas.mpl_connect("motion_notify_event", on_motion)
        plt.show()
