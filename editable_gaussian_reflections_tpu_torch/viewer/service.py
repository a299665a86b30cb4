"""Headless websocket render service - the SERVER mode of the viewer (twin
of the JAX package's viewer/service.py; reference viewer/__init__.py:93-187).

    python -m editable_gaussian_reflections_tpu_torch.viewer.service \\
        -m <model_dir> [--iteration N] [-r RES] [--port 8765] \\
        [--http_port 8080] [--device cpu]

One client at a time, a tick protocol of
  1. JSON metadata (viewer state),
  2. JSON binary mapping,
  3. binary frames (raw RGB8 image bytes),
in both directions - the client sends camera pose + edit state, the server
renders and streams the frame.  The web page is the JAX package's
viewer/client.html, served as it is; tools/viewer_client.py is a headless
client for testing and frame capture.  `serve` needs the `websockets`
package and raises an ImportError naming it where it is missing; `tick` and
`_handle` need nothing beyond the port.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..scene.cameras import MiniCam
from .state import ViewerState

CLIENT_PAGE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "editable_gaussian_reflections_tpu", "viewer", "client.html")


def require_websockets():
    """The `websockets` module, or an ImportError that names it."""
    try:
        import websockets
    except ImportError as e:
        raise ImportError(
            "the viewer's websocket service needs the 'websockets' package, "
            "which is not installed here; drive RenderService.tick directly "
            "or use the LOCAL viewer (viewer/local.py)") from e
    return websockets


def _default_camera(state: ViewerState) -> dict:
    return dict(
        R=np.eye(3).tolist(),
        camera_center=[0.0, 0.0, 0.0],
        fovy=state.fovy,
    )


class RenderService:
    """Synchronous per-tick renderer behind a websocket."""

    def __init__(self, state: ViewerState):
        from collections import deque

        self.state = state
        self.num_connections = 0
        # render-time history for the client's perf-monitor plot (the
        # implot FPS panel of the reference viewer, gaussian_viewer.py)
        self._perf_ms = deque(maxlen=120)

    def tick(self, request: dict) -> tuple[dict, bytes]:
        """One protocol tick: apply client state, render, return
        (metadata, rgb8 bytes)."""
        st = self.state
        if "viewer" in request:
            st.set_state(request["viewer"])
        cam_info = request.get("camera") or _default_camera(st)
        R = np.asarray(cam_info["R"], np.float64)
        center = np.asarray(cam_info["camera_center"], np.float64)
        # a MiniCam-compatible pose (world_view transposed convention)
        w2c = np.eye(4)
        w2c[:3, :3] = R.T
        w2c[:3, 3] = -R.T @ center
        camera = MiniCam(
            width=st.width, height=st.height,
            fovy=cam_info.get("fovy", st.fovy),
            fovx=cam_info.get("fovx", st.fovy),
            znear=st.znear, zfar=st.zfar,
            world_view_transform=w2c.T,
            full_proj_transform=w2c.T,
        )
        if request.get("compute_selections"):
            st.compute_selection_masks(camera)
        if request.get("duplicate"):
            st.duplicate_object(request["duplicate"])
        if request.get("reset_edits"):
            st.reset_edits()

        t0 = time.perf_counter()
        img = st.step(camera)
        # the tick's one copy to the host: the display image as RGB8
        rgb8 = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        render_ms = (time.perf_counter() - t0) * 1e3
        rgb8 = rgb8.tobytes()
        self._perf_ms.append(render_ms)
        metadata = st.get_state()
        metadata["frame_shape"] = [st.height, st.width, 3]
        metadata["perf"] = {
            "render_ms": round(render_ms, 1),
            "fps": round(1000.0 / max(render_ms, 1e-3), 2),
            "history_ms": [round(v, 1) for v in self._perf_ms],
        }
        if request.get("pick") is not None:
            x, y = request["pick"]
            metadata["picked_object"] = st.object_at_pixel(int(x), int(y))
        if request.get("inspect") is not None:
            x, y = request["inspect"]
            metadata["inspect"] = st.inspect_pixel(int(x), int(y))
        if request.get("goto_camera") is not None:
            i = int(request["goto_camera"])
            if 0 <= i < len(st.dataset_cameras):
                metadata["camera_jump"] = st.dataset_cameras[i]
        return metadata, rgb8

    async def _handle(self, websocket):
        if self.num_connections > 0:
            await websocket.close()
            return
        self.num_connections += 1
        # one-frame pipelining: request N's render is submitted BEFORE
        # awaiting request N-1's result, so the render overlaps the
        # websocket send/receive of the previous frame; the client sees one
        # frame of camera latency
        import asyncio
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        loop = asyncio.get_running_loop()
        pending = None
        try:
            while True:
                msg = await websocket.recv()
                request = json.loads(msg)
                fut = loop.run_in_executor(pool, self.tick, request)
                if pending is None:
                    cur = fut          # first frame: reply with its own
                    # (the second request re-sends this cached frame once,
                    # which primes the one-frame pipeline without blocking)
                else:
                    cur = pending      # reply with N-1 while N renders
                pending = fut
                metadata, frame = await cur
                await websocket.send(json.dumps({"viewer": metadata}))
                await websocket.send(json.dumps(["viewer"]))
                await websocket.send(frame)
        except Exception as e:  # noqa: BLE001 - connection teardown
            print(f"INFO: client disconnected ({type(e).__name__})")
        finally:
            pool.shutdown(wait=False)
            self.num_connections -= 1

    def serve(self, host: str = "0.0.0.0", port: int = 8765,
              http_port: Optional[int] = None):
        import asyncio

        websockets = require_websockets()
        if http_port:
            self._serve_client_page(host, http_port, port)

        async def main():
            async with websockets.serve(self._handle, host, port,
                                        max_size=None, compression=None):
                print(f"render service listening on ws://{host}:{port}")
                await asyncio.Future()

        asyncio.run(main())

    @staticmethod
    def _serve_client_page(host: str, http_port: int, ws_port: int):
        """Serve the JAX package's viewer/client.html over plain HTTP in a
        daemon thread so a browser can attach."""
        import http.server
        import threading

        with open(CLIENT_PAGE, "rb") as f:
            page = f.read()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.end_headers()
                self.wfile.write(page)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer((host, http_port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        print(f"viewer page at http://{host}:{http_port}/ "
              f"(websocket on :{ws_port})")


def main(argv: Optional[list] = None):
    import argparse

    p = argparse.ArgumentParser(prog="viewer_service", allow_abbrev=False)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--resolution", "-r", type=int, default=None)
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--http_port", type=int, default=8080,
                   help="serve the web client page here (0 disables)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    require_websockets()  # before the model loads
    state = ViewerState.from_ply(args.model_path, args.iteration,
                                 args.resolution, device=args.device)
    RenderService(state).serve(port=args.port,
                               http_port=args.http_port or None)


if __name__ == "__main__":
    main()
