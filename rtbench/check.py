"""How ``correct`` is decided: what the window's timed path produced, held
against the plain reference (``rtbench/reference/``) once the window has
closed and the program's state is freed.

The answers are the kept jobs or frames: their beauty, albedo and denoised
images on the host, as the program returned them, each with the camera it
was rendered at and the iterations summed since its accumulation began.
Three numbers, each the worst over the answers:

- ``beauty_bad_share``: at ``check_pixels`` pixels drawn from the seed, the
  share whose beauty differs from the reference's render of the same
  iterations at the same camera by more than BEAUTY_ABS + BEAUTY_REL * |r|
  in a channel. The two draw the same numbers, so a sound run differs only
  where rounding sends a path another way (about one path in a million on
  the card); their relative RMS difference, ``beauty_rel_rmse``, is
  reported beside it and not compared, since one such path in a pixel of
  one sample moves it by up to the light's radiance;
- ``albedo_bad_share``: the share of those pixels whose albedo differs from
  the reference's by more than ALBEDO_TOL in a channel;
- ``denoise_rel_rmse``: over every pixel, the program's denoised image
  against the reference U-Net (float32, TF32 off), sqrt(sum (p - r)^2 /
  sum r^2). The U-Net's input is the reference's own whole image where the
  answer sums at most ``full_frame_since`` iterations (a traffic
  parameter), and else the program's beauty and albedo, whose start the
  two numbers above check: a whole image of many iterations costs the
  reference more than a run can spend (PERF.md). Its largest pixel error,
  ``denoise_max_abs``, is reported beside it and not compared: a bfloat16
  U-Net on a 1-sample image reads up to 0.7 there on sound runs.

The control (``control=True``) puts the reference in the program's place
one precision below the configuration's: the render in bfloat16 for its
float32, the U-Net in float8 (e4m3, per-tensor scales) for its bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import pathtrace as ref_pt
from .reference import scene as ref_scene
from .reference import unet as ref_unet

ALBEDO_TOL = 1e-4
BEAUTY_ABS, BEAUTY_REL = 1e-4, 1e-3
NUMBERS = ("beauty_bad_share", "albedo_bad_share", "denoise_rel_rmse")
REPORTED = NUMBERS + ("beauty_rel_rmse", "denoise_max_abs")


def seeds(seed: int) -> dict:
    """Everything the run draws, derived from ``--seed`` (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    render, keep, orbit, pixels = ss.spawn(4)
    return dict(render=int(render.generate_state(1)[0] & 0x7FFFFFFF),
                keep=np.random.default_rng(keep),
                orbit_sign=1.0 if orbit.generate_state(1)[0] & 1 else -1.0,
                pixels=np.random.default_rng(pixels))


def sample_pixels(rng: np.random.Generator, n: int, count: int) -> np.ndarray:
    return np.sort(rng.choice(n, size=min(count, n), replace=False))


def reference_scene(config: dict, resolution=None) -> ref_scene.Scene:
    scene = ref_scene.load_scene(config["scene"])
    w, h = resolution or config["RES"]
    ref_scene.set_resolution(scene, w, h)
    scene.depth = config["DEPTH"]
    return scene


def _at(img: np.ndarray, pixels: np.ndarray) -> np.ndarray:
    """[3, P] of an HxWx3 image at flat pixel indices."""
    return img.reshape(-1, 3)[pixels].T.astype(np.float64)


def rel_rmse(p: np.ndarray, r: np.ndarray) -> float:
    p, r = p.astype(np.float64), r.astype(np.float64)
    return float(np.sqrt(((p - r) ** 2).sum() / max((r ** 2).sum(), 1e-30)))


def render_numbers(beauty, albedo, ref_beauty, ref_albedo, pixels) -> dict:
    p, r = _at(beauty, pixels), ref_beauty.astype(np.float64)
    off = np.abs(p - r) > BEAUTY_ABS + BEAUTY_REL * np.abs(r)
    bad = float((np.abs(_at(albedo, pixels) - ref_albedo).max(axis=0) > ALBEDO_TOL).mean())
    return dict(beauty_bad_share=float(off.any(axis=0).mean()), beauty_rel_rmse=rel_rmse(p, r),
                albedo_bad_share=bad)


class Reference:
    """The reference's scene, tracer and U-Net for one cell on one device."""

    def __init__(self, config: dict, device, resolution=None, control: bool = False):
        self.config, self.device = config, torch.device(device)
        self.scene = reference_scene(config, resolution)
        dtype = torch.bfloat16 if control else torch.float32
        self.tracer = ref_pt.Tracer(self.scene, self.device, dtype)
        weights = ref_unet.read_tza(config["weights"])
        self.net = ref_unet.UNet(weights, self.device, ref_unet.fp8 if control else None)
        self.aa = bool(config["options"].get("antialiasing", True))
        self.sums = {}  # camera -> (iterations summed, their sum, the albedo)

    def render(self, pixels: np.ndarray, iterations: int, seed: int, position=None):
        """(beauty [3, P], albedo [3, P]) of iterations 1 .. ``iterations``
        at the camera moved to ``position`` (None: the scene's). The sum is
        kept per camera, so a later call for more iterations adds only
        those (the same sum, in the same order)."""
        key = None if position is None else tuple(np.asarray(position, np.float32).tolist())
        done, total, albedo = self.sums.get(key, (0, None, None))
        if done > iterations:
            done, total, albedo = 0, None, None
        cam = self.scene.camera if position is None else self.scene.camera.moved(position)
        self.tracer.set_camera(cam)
        pix = torch.as_tensor(pixels, dtype=torch.int64, device=self.device)
        if iterations > done:
            total, alb, _ = self.tracer.render(pix, done + 1, iterations - done, seed, self.aa,
                                               total=total)
            albedo = alb if albedo is None else albedo
        self.sums[key] = (iterations, total, albedo)
        return (total / iterations).float().cpu().numpy(), albedo.float().cpu().numpy()

    def image(self, iterations: int, seed: int, position=None, block: int = 1 << 16):
        """The whole image (beauty, albedo; HxWx3) of iterations 1 ..
        ``iterations``, rendered in blocks of pixels."""
        w, h = self.tracer.resolution
        beauty, albedo = np.zeros((3, w * h), np.float32), np.zeros((3, w * h), np.float32)
        for s in range(0, w * h, block):
            pix = np.arange(s, min(s + block, w * h))
            self.sums.clear()
            beauty[:, pix], albedo[:, pix] = self.render(pix, iterations, seed, position)
        self.sums.clear()
        shape = lambda a: a.T.reshape(h, w, 3)
        return shape(beauty), shape(albedo)

    def denoise(self, beauty, albedo) -> np.ndarray:
        return ref_unet.denoise(self.net, beauty, albedo, self.device)


def numbers(cfg: dict, traffic: dict, draws: dict, answers: list, device, resolution=None,
            control: bool = False) -> tuple[dict, dict | None]:
    """The numbers of ``answers`` (each: beauty, albedo, denoised, the
    camera ``position`` it was rendered at or None, and the iterations
    ``since`` the accumulation began), the worst over them; with
    ``control``, also the control's readings on the same answers."""
    ref = Reference(cfg, device, resolution)
    w, h = ref.tracer.resolution
    pixels = sample_pixels(draws["pixels"], w * h, traffic["check_pixels"])
    full = traffic.get("full_frame_since", 0)
    values = _numbers(ref, answers, draws["render"], pixels, full)
    if not control:
        return values, None
    return values, _numbers(ref, answers, draws["render"], pixels, full,
                            Reference(cfg, device, resolution, control=True))


def _numbers(ref: Reference, answers: list, seed: int, pixels: np.ndarray, full: int,
             control: Reference | None = None) -> dict:
    """The worst readings over ``answers``; ``control`` puts its own render
    and U-Net in the program's place. An answer of at most ``full``
    iterations is denoised by the reference from its own whole image;
    the others from the program's beauty and albedo."""
    worst = dict.fromkeys(REPORTED, 0.0)
    for ans in sorted(answers, key=lambda a: a["since"]):
        its, pos = ans["since"], ans["position"]
        rb, ra = ref.render(pixels, its, seed, pos)
        beauty, albedo, denoised = ans["beauty"], ans["albedo"], ans["denoised"]
        if its <= full:
            ref_in = ref.image(its, seed, pos)
        else:
            ref_in = (beauty, albedo)
        if control is not None:
            cb, ca = control.render(pixels, its, seed, pos)
            if its <= full:
                beauty, albedo = control.image(its, seed, pos)
            else:
                beauty, albedo = _scatter(ans["beauty"], pixels, cb), _scatter(
                    ans["albedo"], pixels, ca)
            denoised = control.denoise(*(beauty, albedo) if its <= full else ref_in)
        got = render_numbers(beauty, albedo, rb, ra, pixels)
        expect = ref.denoise(*ref_in)
        got["denoise_max_abs"] = float(np.abs(denoised.astype(np.float64) - expect).max())
        got["denoise_rel_rmse"] = rel_rmse(denoised, expect)
        worst = {k: max(worst[k], got[k]) for k in REPORTED}
    return worst


def _scatter(img: np.ndarray, pixels: np.ndarray, values: np.ndarray) -> np.ndarray:
    """``img`` (HxWx3) with ``values`` ([3, P]) at the flat ``pixels``."""
    out = np.array(img, np.float32).reshape(-1, 3)
    out[pixels] = values.T
    return out.reshape(img.shape)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: dict(value=values[k], limit=limits[k]) for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
