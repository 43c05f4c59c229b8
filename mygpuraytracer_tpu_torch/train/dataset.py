"""Training datasets for the denoiser U-Net.

The port's own copy of ``mygpuraytracer_tpu/train/dataset.py`` (numpy only;
the port imports nothing of the JAX package): samples are (input, target)
HWC float32 arrays stored as ``<name>.input.npy`` / ``<name>.target.npy``
pairs, randomly cropped to tile_size with the 8-way dihedral augmentation
of the reference's TrainingDataset (training/dataset.py:309-413), and a
deterministic tile grid for validation. ``render_training_pairs`` renders
noisy (color + albedo) / clean pairs with the port's Renderer, through K1
on the card for the primitive scenes K1 supports.
"""

from __future__ import annotations

import os

import numpy as np


class TileDataset:
    """Random tile_size^2 crops with dihedral augmentation."""

    def __init__(self, directory: str, tile_size: int = 256, augment: bool = True, seed: int = 0):
        self.tile = tile_size
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.pairs: list[tuple[str, str]] = []
        for fn in sorted(os.listdir(directory)):
            if fn.endswith(".input.npy"):
                tgt = fn[: -len(".input.npy")] + ".target.npy"
                if os.path.exists(os.path.join(directory, tgt)):
                    self.pairs.append(
                        (os.path.join(directory, fn), os.path.join(directory, tgt))
                    )
        if not self.pairs:
            raise ValueError(f"no .input.npy/.target.npy pairs in {directory}")
        self._cache: dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.pairs)

    def _load(self, path):
        if path not in self._cache:
            self._cache[path] = np.load(path).astype(np.float32)
        return self._cache[path]

    def sample_batch(self, batch_size: int):
        """Returns (inputs [B,T,T,Cin], targets [B,T,T,3])."""
        xs, ys = [], []
        t = self.tile
        for _ in range(batch_size):
            ip, tp = self.pairs[self.rng.integers(len(self.pairs))]
            x = self._load(ip)
            y = self._load(tp)
            h, w = x.shape[:2]
            if h < t or w < t:
                # pad small images (reference requires >= tile; we pad)
                ph, pw = max(t - h, 0), max(t - w, 0)
                x = np.pad(x, ((0, ph), (0, pw), (0, 0)), mode="reflect")
                y = np.pad(y, ((0, ph), (0, pw), (0, 0)), mode="reflect")
                h, w = x.shape[:2]
            i = self.rng.integers(h - t + 1)
            j = self.rng.integers(w - t + 1)
            xc = x[i : i + t, j : j + t]
            yc = y[i : i + t, j : j + t]
            if self.augment:
                k = int(self.rng.integers(8))
                xc = _dihedral(xc, k)
                yc = _dihedral(yc, k)
            xs.append(xc)
            ys.append(yc)
        return np.stack(xs), np.stack(ys)


def _dihedral(img: np.ndarray, k: int) -> np.ndarray:
    """8-way flip/rotation augmentation (dataset.py:309-413)."""
    if k >= 4:
        img = img[:, ::-1]
    return np.ascontiguousarray(np.rot90(img, k % 4))


class ValidationDataset:
    """Deterministic tile grid over each pair — no randomness, no
    augmentation (reference ValidationDataset, training/dataset.py:414-460:
    images are split into a fixed grid of tile_size tiles so the validation
    loss is comparable across epochs and runs)."""

    def __init__(self, directory: str, tile_size: int = 256):
        self.tile = tile_size
        self.pairs: list[tuple[str, str]] = []
        for fn in sorted(os.listdir(directory)):
            if fn.endswith(".input.npy"):
                tgt = fn[: -len(".input.npy")] + ".target.npy"
                if os.path.exists(os.path.join(directory, tgt)):
                    self.pairs.append(
                        (os.path.join(directory, fn), os.path.join(directory, tgt))
                    )
        if not self.pairs:
            raise ValueError(f"no .input.npy/.target.npy pairs in {directory}")
        self._cache: dict[str, np.ndarray] = {}

    def _load(self, path):
        if path not in self._cache:
            self._cache[path] = np.load(path).astype(np.float32)
        return self._cache[path]

    def tiles(self):
        """Yields (input_tile, target_tile) over the deterministic grid."""
        t = self.tile
        for ip, tp in self.pairs:
            x = self._load(ip)
            y = self._load(tp)
            h, w = x.shape[:2]
            if h < t or w < t:
                ph, pw = max(t - h, 0), max(t - w, 0)
                x = np.pad(x, ((0, ph), (0, pw), (0, 0)), mode="reflect")
                y = np.pad(y, ((0, ph), (0, pw), (0, 0)), mode="reflect")
                h, w = x.shape[:2]
            for i in range(0, h - t + 1, t):
                for j in range(0, w - t + 1, t):
                    yield x[i : i + t, j : j + t], y[i : i + t, j : j + t]

    def batches(self, batch_size: int):
        """Yields ([B,T,T,C], [B,T,T,3]) batches; the last batch is padded by
        repeating its first tile so shapes stay static (weights returned too)."""
        xs, ys = [], []
        for x, y in self.tiles():
            xs.append(x)
            ys.append(y)
            if len(xs) == batch_size:
                yield np.stack(xs), np.stack(ys), batch_size
                xs, ys = [], []
        if xs:
            k = len(xs)
            while len(xs) < batch_size:
                xs.append(xs[0])
                ys.append(ys[0])
            yield np.stack(xs), np.stack(ys), k


def render_training_pairs(
    scene_path: str,
    out_dir: str,
    name: str,
    noisy_spp: int = 8,
    clean_spp: int = 512,
    resolution: int | None = 256,
    seed: int = 0,
    device="cuda",
):
    """Render a (noisy color + albedo, clean color) pair and store it as
    .npy files for TileDataset. Both renders run with ``megakernel=True``:
    K1 for the scenes it supports (primitives; on CUDA the kernel, on the
    CPU its plain version), the wavefront for the rest. K1 draws the JAX
    package's threefry stream, so the pair is the JAX function's (which
    renders through its wavefront) up to float rounding."""
    from ..config import RenderOptions
    from ..render import Renderer
    from ..scene import load_scene

    os.makedirs(out_dir, exist_ok=True)
    scene = load_scene(scene_path)
    if resolution is not None:
        scene.set_resolution(resolution, resolution)
    options = RenderOptions(megakernel=True)

    noisy = Renderer(scene, options, seed=seed, device=device)
    noisy.render(iterations=noisy_spp)
    noisy_img = noisy.beauty()
    albedo = noisy.albedo_image()

    clean = Renderer(scene, options, seed=seed + 1, device=device)
    clean.render(iterations=clean_spp)
    clean_img = clean.beauty()

    x = np.concatenate([noisy_img, albedo], axis=-1).astype(np.float32)
    y = clean_img.astype(np.float32)
    np.save(os.path.join(out_dir, f"{name}.input.npy"), x)
    np.save(os.path.join(out_dir, f"{name}.target.npy"), y)
    return x, y
