"""Primary ray generation (SoA).

Equivalent of generateRayFromCamera (apps/src/pathtrace.cu:248-297), as
``mygpuraytracer_tpu/render/camera.py``: one lane per pixel (lane index ==
pixelIndex, row-major x + y*width), stochastic AA jitter of +-0.5 px and
optional thin-lens depth of field via the concentric disk mapping.
"""

from __future__ import annotations

import torch

from ..config import RenderOptions
from ..ops import vec3 as v3
from ..ops.vec3 import Vec3
from ..scene.device_scene import CameraParams


def _concentric_disk(ux, uy):
    """Concentric disk mapping (pathtrace.cu:225-239), SoA."""
    ox = 2.0 * ux - 1.0
    oy = 2.0 * uy - 1.0
    use_x = ox.abs() > oy.abs()
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, 0.785398 * (oy / safe_ox), 1.570796 - 0.785398 * (ox / safe_oy))
    degen = (ox == 0.0) & (oy == 0.0)
    px = torch.where(degen, 0.0, r * torch.cos(theta))
    py = torch.where(degen, 0.0, r * torch.sin(theta))
    return px, py


def generate_camera_rays(
    cam: CameraParams,
    resolution: tuple[int, int],
    options: RenderOptions,
    uniforms: torch.Tensor,  # [>=4, count] rows: aa_x, aa_y, dof_u, dof_v
    p0: int = 0,
):
    """Returns (origins Vec3, directions Vec3) over the lanes of pixels
    p0 .. p0 + count - 1 (count = the uniforms' columns; the whole image:
    p0 = 0, count = W*H)."""
    width, height = resolution
    n = uniforms.shape[1]
    idx = torch.arange(p0, p0 + n, dtype=torch.int32, device=uniforms.device)
    x = (idx % width).float()
    y = torch.div(idx, width, rounding_mode="floor").float()

    if options.antialiasing:
        x = x + (uniforms[0] - 0.5)  # U(-0.5, 0.5), pathtrace.cu:267
        y = y + (uniforms[1] - 0.5)

    pl = cam.pixel_length
    sx = pl[0] * (x - width * 0.5)
    sy = pl[1] * (y - height * 0.5)
    view, right, up = cam.view, cam.right, cam.up
    d = v3.normalize(Vec3(
        view[0] - right[0] * sx - up[0] * sy,
        view[1] - right[1] * sx - up[1] * sy,
        view[2] - right[2] * sx - up[2] * sy,
    ))
    pos = cam.position
    o = Vec3(pos[0].expand(n), pos[1].expand(n), pos[2].expand(n))

    if options.depth_of_field and options.lens_radius > 0:
        px, py = _concentric_disk(uniforms[2], uniforms[3])
        px = options.lens_radius * px
        py = options.lens_radius * py
        ft = torch.abs(options.focal_distance / d.z)
        focus = Vec3(o.x + d.x * ft, o.y + d.y * ft, o.z + d.z * ft)
        o = Vec3(o.x + px, o.y + py, o.z)
        d = v3.normalize(focus - o)

    return o, d
