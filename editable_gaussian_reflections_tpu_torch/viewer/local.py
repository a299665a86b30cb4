"""LOCAL viewer mode: an in-process GUI over the render-service tick (twin
of the JAX package's viewer/local.py).

The reference viewer's LOCAL mode is an imgui app in the training/render
process (viewer/__init__.py:16, gaussian_viewer.py:882-892).  Here it is a
tkinter shell (stdlib, no extra dependencies) over the same
`RenderService.tick` the websocket SERVER mode uses - one code path for
both, no socket in between:

  python -m editable_gaussian_reflections_tpu_torch.viewer.local \
      -m <model_dir> [--device cpu]

Orbit with left-drag, zoom with the wheel, click an object to select it,
alt-click to inspect a pixel's G-buffer; the side panel mirrors the web
client's controls (render mode, exposure, bounces, edit sliders,
duplicate/reset).  Needs a display ($DISPLAY / local desktop); on a
headless machine use the SERVER mode and the web client instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .service import RenderService
from .state import RENDER_MODES, ViewerState

EDIT_FIELDS = [  # (field, lo, hi) - the web client's slider set
    ("roughness_shift", -1.0, 1.0),
    ("roughness_mult", 0.0, 3.0),
    ("diffuse_hue_shift", -3.2, 3.2),
    ("diffuse_saturation_mult", 0.0, 3.0),
    ("diffuse_value_mult", 0.0, 3.0),
    ("specular_hue_shift", -3.2, 3.2),
    ("translate_x", -3.0, 3.0),
    ("translate_y", -3.0, 3.0),
    ("translate_z", -3.0, 3.0),
    ("scale", 0.1, 3.0),
    ("rotate_x", -180.0, 180.0),
    ("rotate_y", -180.0, 180.0),
    ("rotate_z", -180.0, 180.0),
]
EDIT_DEFAULTS = {"roughness_mult": 1.0, "diffuse_saturation_mult": 1.0,
                 "diffuse_value_mult": 1.0, "scale": 1.0}


@dataclass
class OrbitCamera:
    """The web client's orbit camera (client.html camPose) as a pure
    function of (target, dist, yaw, pitch) - kept GUI-free so it is
    testable without a display."""

    target: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    dist: float = 4.0
    yaw: float = 0.6
    pitch: float = -0.25
    fovy: float = 0.9

    def basis(self):
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        fwd = np.array([cp * sy, sp, cp * cy])
        eye = self.target - fwd * self.dist
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(right, fwd)
        return eye, right, up, fwd

    def camera_dict(self) -> dict:
        """Pose in the tick-protocol convention: R columns are
        (right, -up, fwd) - see client.html camPose / service MiniCam."""
        eye, right, up, fwd = self.basis()
        R = np.stack([right, -up, fwd], axis=1)
        return dict(R=R.tolist(), camera_center=eye.tolist(),
                    fovy=self.fovy)


class LocalViewer:
    """tkinter shell over RenderService.tick (the LOCAL mode)."""

    def __init__(self, state: ViewerState):
        import tkinter as tk

        self.service = RenderService(state)
        self.cam = OrbitCamera(fovy=state.fovy)
        self.viewer_state: dict = {"edits": {}}
        self.selected: Optional[str] = None
        self._pending: dict = {}
        self._drag = None

        self.root = tk.Tk()
        self.root.title("editable-gaussian-reflections (LOCAL)")
        self.canvas = tk.Label(self.root, bg="black")
        self.canvas.grid(row=0, column=0, sticky="nsew")
        panel = tk.Frame(self.root)
        panel.grid(row=0, column=1, sticky="ns")
        self.root.grid_columnconfigure(0, weight=1)
        self.root.grid_rowconfigure(0, weight=1)

        # display controls --------------------------------------------------
        self.status = tk.Label(panel, text="starting…", anchor="w")
        self.status.pack(fill="x")
        self.mode_var = tk.StringVar(value=RENDER_MODES[0])
        tk.OptionMenu(panel, self.mode_var, *RENDER_MODES,
                      command=lambda _=None: self._set_mode()).pack(fill="x")
        self.exposure = self._scale(panel, "exposure", 0.05, 6.0, 1.0)
        self.bounces = self._scale(panel, "bounces", 0, 2, 2, integer=True)
        self.znear = self._scale(panel, "znear", 0.01, 3.0, 0.05)

        # objects + edits ---------------------------------------------------
        tk.Label(panel, text="objects (click image to pick)").pack()
        self.objlist = tk.Listbox(panel, height=5, exportselection=False)
        self.objlist.pack(fill="x")
        self.objlist.bind("<<ListboxSelect>>", self._on_select_obj)
        row = tk.Frame(panel)
        row.pack(fill="x")
        tk.Button(row, text="duplicate", command=self._dup).pack(side="left")
        tk.Button(row, text="reset edits",
                  command=lambda: self._pending.update(reset_edits=True)
                  ).pack(side="left")
        self.editframe = tk.Frame(panel)
        self.editframe.pack(fill="x")
        self.edit_scales: dict = {}

        # mouse bindings ----------------------------------------------------
        self.canvas.bind("<ButtonPress-1>", self._press)
        self.canvas.bind("<B1-Motion>", self._motion)
        self.canvas.bind("<ButtonRelease-1>", self._release)
        self.canvas.bind("<MouseWheel>", self._wheel)
        self.canvas.bind("<Button-4>", lambda e: self._zoom(0.9))
        self.canvas.bind("<Button-5>", lambda e: self._zoom(1.1))

        self._photo = None

    # -- widget helpers -----------------------------------------------------

    def _scale(self, parent, name, lo, hi, init, integer=False):
        import tkinter as tk

        var = (tk.IntVar if integer else tk.DoubleVar)(value=init)
        tk.Label(parent, text=name, anchor="w").pack(fill="x")
        tk.Scale(parent, from_=lo, to=hi, orient="horizontal", variable=var,
                 resolution=1 if integer else (hi - lo) / 200.0
                 ).pack(fill="x")
        return var

    def _set_mode(self):
        self.viewer_state["render_mode"] = RENDER_MODES.index(
            self.mode_var.get())

    def _on_select_obj(self, _event=None):
        sel = self.objlist.curselection()
        if sel:
            self.selected = self.objlist.get(sel[0])
            self._rebuild_edit_panel()

    def _rebuild_edit_panel(self):
        import tkinter as tk

        for w in self.editframe.winfo_children():
            w.destroy()
        self.edit_scales = {}
        if not self.selected:
            return
        ed = self.viewer_state["edits"].setdefault(self.selected, {})
        for f, lo, hi in EDIT_FIELDS:
            var = tk.DoubleVar(value=ed.get(f, EDIT_DEFAULTS.get(f, 0.0)))
            tk.Scale(self.editframe, from_=lo, to=hi, orient="horizontal",
                     label=f, variable=var,
                     resolution=(hi - lo) / 200.0).pack(fill="x")
            self.edit_scales[f] = var

    def _collect_edits(self):
        if self.selected and self.edit_scales:
            ed = self.viewer_state["edits"].setdefault(self.selected, {})
            for f, var in self.edit_scales.items():
                ed[f] = float(var.get())

    def _dup(self):
        if self.selected:
            self._pending["duplicate"] = self.selected

    # -- mouse --------------------------------------------------------------

    def _press(self, e):
        self._drag = (e.x, e.y, False)
        # fast drag: quarter-ray preview while orbiting (state.preview_scale
        # nearest-upscales, so pick coordinates stay full-res)
        self.viewer_state["preview_scale"] = 2

    def _motion(self, e):
        if not self._drag:
            return
        x0, y0, _ = self._drag
        dx, dy = e.x - x0, e.y - y0
        self.cam.yaw -= dx * 0.005
        self.cam.pitch = max(-1.5, min(1.5, self.cam.pitch - dy * 0.005))
        self._drag = (e.x, e.y, True)

    def _release(self, e):
        self.viewer_state["preview_scale"] = 1
        if self._drag and not self._drag[2]:
            st = self.service.state
            w = self.canvas.winfo_width() or st.width
            h = self.canvas.winfo_height() or st.height
            px = int(e.x * st.width / max(w, 1))
            py = int(e.y * st.height / max(h, 1))
            if e.state & 0x8:  # alt held: pixel inspector
                self._pending["inspect"] = [px, py]
            else:
                self._pending["compute_selections"] = True
                self._pending["pick"] = [px, py]
        self._drag = None

    def _wheel(self, e):
        self._zoom(math.exp(-e.delta * 0.001))

    def _zoom(self, f):
        self.cam.dist *= f

    # -- render loop ---------------------------------------------------------

    def _tick_request(self) -> dict:
        import copy

        self._collect_edits()
        self.viewer_state["exposure"] = float(self.exposure.get())
        self.viewer_state["num_bounces"] = int(self.bounces.get())
        self.viewer_state["znear"] = float(self.znear.get())
        # deep-copy: the worker thread iterates this dict inside set_state
        # while the Tk main thread keeps mutating the live edits
        req = dict(viewer=copy.deepcopy(self.viewer_state),
                   camera=self.cam.camera_dict())
        req.update(self._pending)
        self._pending = {}
        return req

    def _apply_metadata(self, meta: dict):
        objs = meta.get("objects", [])
        if list(self.objlist.get(0, "end")) != objs:
            self.objlist.delete(0, "end")
            for o in objs:
                self.objlist.insert("end", o)
        if meta.get("picked_object"):
            self.selected = meta["picked_object"]
            self._rebuild_edit_panel()
        if meta.get("inspect"):
            self.status.config(text=str(meta["inspect"]))
        elif meta.get("perf"):
            p = meta["perf"]
            self.status.config(
                text=f"render {p['render_ms']} ms ({p['fps']} fps)")

    def _show(self, meta: dict, rgb8: bytes):
        import tkinter as tk

        h, w, _ = meta["frame_shape"]
        ppm = b"P6 %d %d 255\n" % (w, h) + rgb8
        self._photo = tk.PhotoImage(data=ppm)
        self.canvas.config(image=self._photo)

    def run(self):
        import queue
        import threading

        results: "queue.Queue" = queue.Queue(maxsize=1)

        def worker():
            while True:
                req = requests.get()
                if req is None:
                    return
                results.put(self.service.tick(req))

        requests: "queue.Queue" = queue.Queue(maxsize=1)
        threading.Thread(target=worker, daemon=True).start()
        requests.put(self._tick_request())

        def poll():
            try:
                meta, rgb8 = results.get_nowait()
            except queue.Empty:
                self.root.after(15, poll)
                return
            self._apply_metadata(meta)
            self._show(meta, rgb8)
            requests.put(self._tick_request())  # pipeline the next frame
            self.root.after(1, poll)

        self.root.after(1, poll)
        try:
            self.root.mainloop()
        finally:
            requests.put(None)


def main(argv: Optional[list] = None):
    import argparse

    p = argparse.ArgumentParser(prog="viewer_local", allow_abbrev=False)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--resolution", "-r", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    state = ViewerState.from_ply(args.model_path, args.iteration,
                                 args.resolution, device=args.device)
    LocalViewer(state).run()


if __name__ == "__main__":
    main()
