"""The live preview, as the reference's GL window runs it: every frame one
Monte-Carlo iteration and the denoise of the image so far (``runCuda``,
main.cpp:221-281, once a frame from preview.cpp:172-211's ``mainLoop``),
after the camera's change, which zeroes the accumulation (main.cpp:222-240).
A frame here is the port's fused path: ``move_camera`` when the frame
moves, then ``Renderer.render_denoised(iterations=spp_per_frame)``, the
denoised image and the beauty on the host. It is timed from its start (its
move included) to its images on the host; the window ends at the first
frame boundary at or after ``seconds``. ``frames_per_s`` is every frame
over the window's wall, ``frame_ms_p95`` the 95th percentile of every
frame's time.

The regime is ``drag_px``:

- 0 (mix ``still``): the camera holds and the image accumulates;
- above 0 (mix ``drag``): a mouse button is held and dragged sideways, so
  every frame moves the camera first. The mouse callback (main.cpp:309-339;
  the port's ``apps/preview.py::OrbitCamera.orbit``) turns phi by
  -dx / width for dx pixels of motion, and the loop takes all the motion
  since the last frame at once: dx is ``drag_px`` a frame. The drag sweeps
  back and forth across the scene's camera, ``sweep_frames`` frames to each
  side, its first stroke's side drawn from the seed: the camera stays in a
  fixed arc, and every seed renders the same views, both sides alike.

Frame n counts from the first warm-up frame (n = 0, the scene's own
camera). Parameters: ``spp_per_frame``, ``drag_px``, ``sweep_frames`` (a
drag's), ``check_answers``, ``check_pixels``, ``trace_frames`` (the window's
first frames, profiled as one slice), and those that ``check.py`` reads. The interface is ``loops/converge.py``'s.
"""

from __future__ import annotations

import math
import time

import numpy as np

from rtbench import check, core
from rtbench.program import Program
from rtbench.reference import scene as ref_scene

numbers = check.numbers
WARM_FRAMES = 3  # the eager first iteration, the graph's capture, a replay


def orbit_position(eye, look_at, dphi: float) -> np.ndarray:
    """The OrbitCamera's position (look_at + zoom * (sin phi sin theta,
    cos theta, cos phi sin theta)) with phi turned by ``dphi``: theta, the
    zoom and the look-at point held."""
    look = np.asarray(look_at, np.float64)
    off = np.asarray(eye, np.float64) - look
    zoom = float(np.linalg.norm(off))
    theta = math.acos(max(-1.0, min(1.0, off[1] / zoom)))
    phi = math.atan2(off[0], off[2]) + dphi
    st = math.sin(theta)
    unit = np.array([math.sin(phi) * st, math.cos(theta), math.cos(phi) * st])
    return (look + zoom * unit).astype(np.float32)


def sweep(n: int, frames: int) -> int:
    """The drag's offset in steps at frame n: 0, 1, ..., frames, ..., 0, -1,
    ..., -frames, ..., 0, 1, ... (a period of 4 * frames); each frame one
    step from the last, both sides of the scene's camera alike."""
    p = n % (4 * frames)
    if p <= frames:
        return p
    return 2 * frames - p if p <= 3 * frames else p - 4 * frames


class Frames(Program):
    """The program, and the camera path that the traffic and the seed give."""

    def __init__(self, cfg: dict, traffic: dict, draws: dict, device, resolution=None):
        super().__init__(cfg, draws["render"], device, resolution)
        self.traffic, self.n, self.since = traffic, 0, 0
        cam = ref_scene.load_scene(cfg["scene"], meshes=False).camera
        self.eye, self.look_at = cam.position, cam.look_at
        self.step = draws["orbit_sign"] * traffic["drag_px"] / (resolution or cfg["RES"])[0]

    def position(self, n: int):
        """Where frame n moves the camera, or None (it holds)."""
        if not self.traffic["drag_px"]:
            return None
        return orbit_position(self.eye, self.look_at,
                              -self.step * sweep(n, self.traffic["sweep_frames"]))

    def next_frame(self) -> dict:
        pos = self.position(self.n)
        if pos is not None:
            self.since = 0
        out = self.frame(pos, self.traffic["spp_per_frame"])
        self.since += self.traffic["spp_per_frame"]
        self.n += 1
        out.update(position=pos, since=self.since)
        return out


build = Frames


def warm_up(f: Frames, traffic: dict, draws: dict) -> None:
    """The mix's first frames: the eager first iteration, the graph's
    capture and a replay (still), or as many moved frames (drag)."""
    for _ in range(WARM_FRAMES):
        f.next_frame()


def window(f: Frames, traffic: dict, draws: dict, seconds: float, keep, tracer=None) -> dict:
    times = []
    stop = traffic.get("trace_frames", 0) if tracer else 0
    seg = tracer.segment("frames", frames=stop) if stop else None
    if seg:
        seg.start()
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        slot = keep.wants()
        out = f.next_frame()
        now = time.perf_counter()
        times.append(now - t)
        if slot is not None:  # the albedo it denoised with, copied on the device
            out["albedo_rows"] = f.albedo_on_device()
        keep.offer(slot, out)
        if seg and len(times) == stop:
            seg.stop()
            seg = None
        if now - t0 >= seconds and seg is None:
            break
    elapsed = now - t0
    for ans in keep.answers():  # after the window: the kept albedo to the host
        rows = ans.pop("albedo_rows", None)
        ans["albedo"] = f.albedo_to_host(rows if rows is not None else f.albedo_on_device())
    return dict(attempted=len(times), times=times, elapsed=elapsed,
                end_to_end=dict(frames_per_s=len(times) / elapsed,
                                frame_ms_p95=1e3 * core.p95(times)))
