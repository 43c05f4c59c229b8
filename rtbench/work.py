"""The work counts the rooflines and peak shares divide by, and the table of
peaks. They read the configuration and the scene file, never the program,
so they count the same work whatever implements it.

The render count is per camera sample::

    raygen + segments_per_sample * (sum over primitives of their test + shade)

- ``segments_per_sample``: the path segments (ray-scene queries on a live
  path) a sample needs, as the plain reference traces them; a constant of
  the configuration, stored in its file with how it was measured;
- each segment tests every primitive once (no acceleration structure is
  visited) and shades the hit once.

Operation counts are FP32 arithmetic operations (an add, multiply, divide,
min, max, square root, reciprocal square root, sine, cosine or power is one;
a fused multiply-add is two, as the peak counts it); comparisons, selects
and integer work (the threefry draws) are not counted:

- RAYGEN 32: the jittered pixel (4), its offset from the center times the
  pixel size (4), the direction view - right*sx - up*sy (12), its
  normalization (dot 5, rsqrt 1, scale 3), and the path's color times pi at
  its end (3);
- CUBE 122: the ray to object space (point 18, direction 15) and the
  direction's normalization (9); three slabs, each two subtract-divides and
  a min and a max (18); the entry and exit (4); the hit point pulled back
  along the local ray (7) and taken to world space (18); the world distance
  (3 subtracts, a dot, a square root: 9); the normal's transform and
  normalization (24);
- SPHERE 121: object space and normalization (42); the quadratic (two dots,
  the radicand, its root, two roots, a min and a max: 18); the hit point (7)
  in world space (18); the normal from the local point, normalized and
  oriented (27); the world distance (9);
- SHADE 74, a diffuse bounce (every surface of the configurations counted
  here is diffuse or the light): the hit point (6), the cosine hemisphere
  (three square-root and angle terms 4, two crosses 18, two normalizations
  18, cosine and sine with their scale 4, the direction 15), the offset
  origin (6), the color update (3).
"""

from __future__ import annotations

from rtbench.reference import scene as ref_scene

RAYGEN = 32
PRIMITIVE_TEST = {"cube": 122, "sphere": 121}
SHADE = 74

# Published dense peaks of one card (NVIDIA's data sheet, SXM part, at the
# full 700 W power limit): FP32 outside the tensor cores, and bf16.
PEAKS = {"H100": dict(fp32=67e12, bf16=989e12, hbm_bytes=3.35e12)}

# The OIDN U-Net's convs (training/model.py; OIDN 1.4.2): (name, in, out,
# downscale of its input). "in" of enc_conv0 and the last skip is the
# input's channels C.
UNET_CONVS = (
    ("enc_conv0", "C", 32, 1), ("enc_conv1", 32, 32, 1), ("enc_conv2", 32, 48, 2),
    ("enc_conv3", 48, 64, 4), ("enc_conv4", 64, 80, 8), ("enc_conv5a", 80, 96, 16),
    ("enc_conv5b", 96, 96, 16), ("dec_conv4a", 96 + 64, 112, 8), ("dec_conv4b", 112, 112, 8),
    ("dec_conv3a", 112 + 48, 96, 4), ("dec_conv3b", 96, 96, 4), ("dec_conv2a", 96 + 32, 64, 2),
    ("dec_conv2b", 64, 64, 2), ("dec_conv1a", "64+C", 64, 1), ("dec_conv1b", 64, 32, 1),
    ("dec_conv0", 32, 3, 1),
)


def unet_flops(h: int, w: int, channels: int) -> int:
    """FLOPs (2 per multiply-add) of the U-Net's 3x3 convs on an h x w
    image padded to multiples of 16."""
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    total = 0
    for _, cin, cout, down in UNET_CONVS:
        cin = {"C": channels, "64+C": 64 + channels}.get(cin, cin)
        total += 2 * 9 * cin * cout * (hp // down) * (wp // down)
    return total


def render_flops_per_sample(primitives: list[str], segments_per_sample: float) -> float | None:
    """The count above for a scene of ``primitives`` (kinds); None for a
    scene with a kind the table does not count (a triangle mesh)."""
    if any(p not in PRIMITIVE_TEST for p in primitives):
        return None
    per_segment = sum(PRIMITIVE_TEST[p] for p in primitives) + SHADE
    return RAYGEN + segments_per_sample * per_segment


def counts(cfg: dict, resolution=None) -> dict:
    """The work counts of a configuration: the render count per sample (None
    without ``work.segments_per_sample`` or for a scene the table does not
    count) and the U-Net's FLOPs per frame."""
    segs = cfg.get("work", {}).get("segments_per_sample")
    kinds = [g.kind for g in ref_scene.load_scene(cfg["scene"], meshes=False).geoms]
    w, h = resolution or cfg["RES"]
    return dict(render_flops_per_sample=render_flops_per_sample(kinds, segs) if segs else None,
                unet_flops_per_frame=unet_flops(h, w, cfg["denoise_channels"]))


def peaks(device_name: str) -> dict:
    return next((v for k, v in PEAKS.items() if k in device_name), {})
