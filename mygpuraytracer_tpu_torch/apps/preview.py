"""Progressive interactive preview, the GL window's substitute.

The port's counterpart of ``mygpuraytracer_tpu/apps/preview.py``. The
reference's preview (apps/src/preview.cpp:136-211 + main.cpp:221-339) is a
GLFW window fed by a CUDA-GL pixel buffer: every frame runs one MC batch,
the title shows the iteration count and fps, and the mouse drives an orbit
camera (left = orbit, right = zoom, middle = pan; SPACE recenters, S saves,
ESC saves and exits). Any camera change zeroes the accumulator.

Here the window is an HTTP live view: a background thread accumulates
sample batches on the device (``Renderer.step_many``: K1 on the card for
the primitive scenes) while a small stdlib server streams the current frame
as PNG and takes the same camera verbs (``Renderer.move_camera``). Open
http://localhost:PORT in a browser; drag to orbit, right-drag or wheel to
zoom, shift-drag to pan.

Usage:
    python -m mygpuraytracer_tpu_torch.apps.preview SCENE [--port 8265] [--device cuda] [...]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time

import numpy as np

from ..utils.platform import add_device_flag, resolve_device
from ..utils.png import encode_png  # in-memory PNG of a float [0,1] HxWx3 image
from .raytrace import denoise_beauty, load_any_scene, mirror_x

PI = math.pi


class OrbitCamera:
    """Spherical camera state, main.cpp:62-81 / 222-240 semantics.

    position = lookAt + zoom * (sin(phi)sin(theta), cos(theta), cos(phi)sin(theta))
    """

    def __init__(self, cam):
        offset = np.asarray(cam.position, np.float64) - np.asarray(
            cam.look_at, np.float64
        )
        self.zoom = float(np.linalg.norm(offset))
        self.theta = float(math.acos(np.clip(offset[1] / self.zoom, -1.0, 1.0)))
        self.phi = float(math.atan2(offset[0], offset[2]))
        self.look_at = np.asarray(cam.look_at, np.float64).copy()
        self.og_look_at = self.look_at.copy()

    # mousePositionCallback, main.cpp:309-339 ------------------------------
    def orbit(self, dx: float, dy: float, width: int, height: int) -> None:
        self.phi -= dx / width
        self.theta -= dy / height
        self.theta = max(0.001, min(self.theta, PI))

    def zoom_by(self, dy: float, height: int) -> None:
        self.zoom += dy / height
        self.zoom = max(0.1, self.zoom)

    def pan(self, dx: float, dy: float) -> None:
        # forward/right flattened to the ground plane (main.cpp:326-334)
        view = -self._offset_unit()
        fwd = np.array([view[0], 0.0, view[2]])
        n = np.linalg.norm(fwd)
        if n > 1e-9:
            fwd /= n
        right = np.cross(view, np.array([0.0, 1.0, 0.0]))
        right[1] = 0.0
        n = np.linalg.norm(right)
        if n > 1e-9:
            right /= n
        self.look_at = self.look_at - dx * right * 0.01 + dy * fwd * 0.01

    def recenter(self) -> None:  # SPACE, main.cpp:293-298
        self.look_at = self.og_look_at.copy()

    def _offset_unit(self) -> np.ndarray:
        st, ct = math.sin(self.theta), math.cos(self.theta)
        return np.array(
            [math.sin(self.phi) * st, ct, math.cos(self.phi) * st]
        )

    def position(self) -> np.ndarray:
        return self.look_at + self.zoom * self._offset_unit()


class PreviewSession:
    """Owns the renderer (on ``device``), the progressive loop, and the
    camera state."""

    def __init__(self, scene, options, iterations=None, batch=8, seed=0, device="cuda"):
        from ..render import Renderer

        self.renderer = Renderer(scene, options, seed=seed, device=device)
        self.scene = scene
        self.iterations = (
            iterations if iterations is not None else scene.state.iterations
        )
        self.batch = batch
        self.orbit = OrbitCamera(scene.state.camera)
        self.lock = threading.Lock()
        self.camera_dirty = False
        self.stop_flag = False
        self.fps = 0.0
        self.saved: list[str] = []
        self.out_dir = "."
        self._frame = np.zeros(
            (scene.state.camera.resolution[1], scene.state.camera.resolution[0], 3),
            np.float32,
        )
        self._albedo = self._frame
        self._frame_iter = -1
        # Monotone count of accumulator resets actually applied (camera
        # moves); lets clients/tests detect a reset without having to catch
        # the iteration counter mid-dip between two polls.
        self.resets = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)

    # -- progressive loop (runCuda analog, main.cpp:221-281) ----------------
    def _loop(self) -> None:
        # Launches go to the current device of this thread: make it the
        # Renderer's before the first one.
        if self.renderer.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.renderer.acc.device)  # a tensor's device has its index
        while not self.stop_flag:
            with self.lock:
                if self.camera_dirty:
                    self.renderer.move_camera(
                        position=self.orbit.position(),
                        look_at=self.orbit.look_at,
                    )
                    self.camera_dirty = False
                    self.resets += 1
            if self.renderer.iteration >= self.iterations:
                time.sleep(0.05)
                continue
            n = min(self.batch, self.iterations - self.renderer.iteration)
            t0 = time.perf_counter()
            self.renderer.step_many(n)
            # Snapshot every output here: only this thread touches the
            # renderer.
            beauty = self.renderer.beauty()  # copies to the host: waits for the device
            albedo = self.renderer.albedo_image()
            dt = time.perf_counter() - t0
            with self.lock:
                self._frame = beauty
                self._albedo = albedo
                self._frame_iter = self.renderer.iteration
                self.fps = n / dt if dt > 0 else 0.0

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self.stop_flag = True
        if self.thread.is_alive():
            self.thread.join(timeout=10)

    # -- verbs ---------------------------------------------------------------
    def apply_camera(self, msg: dict) -> None:
        cam = self.scene.state.camera
        w, h = cam.resolution
        with self.lock:
            moved = False
            if "orbit" in msg:
                dx, dy = msg["orbit"]
                self.orbit.orbit(float(dx), float(dy), w, h)
                moved = True
            if "zoom" in msg:
                self.orbit.zoom_by(float(msg["zoom"]), h)
                moved = True
            if "pan" in msg:
                dx, dy = msg["pan"]
                self.orbit.pan(float(dx), float(dy))
                moved = True
            if msg.get("recenter"):
                self.orbit.recenter()
                moved = True
            # Only a recognized verb resets the accumulator (an empty POST
            # must not restart progressive accumulation).
            if moved:
                self.camera_dirty = True

    def state(self) -> dict:
        with self.lock:
            return {
                "iteration": int(self._frame_iter if self._frame_iter >= 0 else 0),
                "iterations": int(self.iterations),
                "fps": round(self.fps, 1),
                "zoom": round(self.orbit.zoom, 3),
                "done": bool(self.renderer.iteration >= self.iterations),
                "resets": int(self.resets),
                "saved": list(self.saved),
            }

    def frame(self) -> tuple[np.ndarray, int]:
        with self.lock:
            return self._frame, self._frame_iter

    def save(self, denoise: bool = True) -> list[str]:
        """saveImage (main.cpp:115-165): samp + albedo (+ denoised output)."""
        import os

        from ..utils.png import write_png

        with self.lock:
            beauty, albedo, it = self._frame, self._albedo, self._frame_iter
        if it <= 0:
            return []
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        prefix = os.path.join(
            self.out_dir, f"{self.scene.state.image_name}.{stamp}.{it}"
        )
        paths = [f"{prefix}samp.png", f"{prefix}albedo.png"]
        write_png(paths[0], mirror_x(beauty))
        write_png(paths[1], mirror_x(albedo))
        if denoise:
            out, _ = denoise_beauty(beauty, albedo, self.renderer.device)
            paths.append(f"{prefix}output.png")
            write_png(paths[2], mirror_x(out))
        with self.lock:
            self.saved.extend(paths)
        return paths


_PAGE = """<!DOCTYPE html>
<html><head><title>GPU Path Tracer</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;
      display:flex;flex-direction:column;align-items:center}
 #bar{padding:6px}
 img{image-rendering:pixelated;cursor:grab;border:1px solid #333}
 button{margin-left:8px}
</style></head><body>
<div id="bar"><span id="status">connecting…</span>
 <button onclick="post('/save',{})">Save [S]</button>
 <button onclick="post('/camera',{recenter:true})">Recenter [space]</button>
</div>
<img id="view" width="%W%" height="%H%">
<script>
const img=document.getElementById('view'),st=document.getElementById('status');
let drag=null;
function post(u,b){fetch(u,{method:'POST',body:JSON.stringify(b)});}
img.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,b:e.button,s:e.shiftKey};
                    e.preventDefault();};
img.oncontextmenu=e=>e.preventDefault();
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{
  if(!drag)return;
  const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
  drag.x=e.clientX;drag.y=e.clientY;
  if(drag.s||drag.b===1)post('/camera',{pan:[dx,dy]});
  else if(drag.b===2)post('/camera',{zoom:dy});
  else post('/camera',{orbit:[dx,dy]});
};
img.onwheel=e=>{post('/camera',{zoom:e.deltaY});e.preventDefault();};
window.onkeydown=e=>{
  if(e.key==='s'||e.key==='S')post('/save',{});
  if(e.key===' '){post('/camera',{recenter:true});e.preventDefault();}
};
setInterval(()=>{img.src='/frame.png?t='+Date.now();},500);
setInterval(async()=>{
  const s=await (await fetch('/state')).json();
  st.textContent=`GPU Path Tracer | ${s.iteration}/${s.iterations} `+
                 `iterations [${s.fps} sps] zoom=${s.zoom}`+
                 (s.done?' (done)':'');
  document.title=`GPU Path Tracer | ${s.iteration} Iterations`;
},500);
</script></body></html>"""


def make_server(session: PreviewSession, port: int = 0):
    """HTTP facade over a PreviewSession (stdlib only)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    w, h = session.scene.state.camera.resolution
    page = _PAGE.replace("%W%", str(w)).replace("%H%", str(h)).encode()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                frame, _ = session.frame()
                self._send(200, encode_png(mirror_x(frame)), "image/png")
            elif self.path.startswith("/state"):
                self._send(200, json.dumps(session.state()).encode())
            elif self.path == "/":
                self._send(200, page, "text/html")
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._send(400, b'{"error":"bad json"}')
                return
            if self.path == "/camera":
                session.apply_camera(msg)
                self._send(200, b"{}")
            elif self.path == "/save":
                paths = session.save(denoise=bool(msg.get("denoise", False)))
                self._send(200, json.dumps({"saved": paths}).encode())
            else:
                self._send(404, b"{}")

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Progressive live preview")
    p.add_argument("scene")
    p.add_argument("--port", type=int, default=8265)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--resolution", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    p.add_argument("--batch", type=int, default=8,
                   help="iterations per device dispatch between frame updates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=".")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import RenderOptions

    device = resolve_device(args.device)
    scene = load_any_scene(args.scene)
    if args.resolution:
        scene.set_resolution(*args.resolution)
    # The raytrace app's --megakernel auto: K1 on CUDA for the scenes it takes.
    session = PreviewSession(
        scene, RenderOptions(megakernel=device.type == "cuda"), iterations=args.iterations,
        batch=args.batch, seed=args.seed, device=device,
    )
    session.out_dir = args.out_dir
    server = make_server(session, args.port)
    session.start()
    host, port = server.server_address
    print(f"preview at http://{host}:{port}  (Ctrl-C to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        session.save(denoise=False)  # ESC saves on exit (main.cpp:286-288)
        session.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
