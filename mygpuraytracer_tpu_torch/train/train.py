"""U-Net trainer on one device: host-fed (``train``) and device-resident
(``train_device``).

The port of ``mygpuraytracer_tpu/train/train.py`` (reference
training/train.py): Adam under the one-cycle cosine schedule with 15%
warm-up, global-norm clipping at 1.0, the L1 + MS-SSIM loss by default,
"mixed" precision (bfloat16 activations over float32 master weights),
checkpoints every ``save_epochs`` with auto-resume and config-mismatch
detection, validation on a fixed tile grid, and a JSONL log.

What optax did in the JAX package is written out here so that it computes
the same numbers:

- the schedule is ``optax.cosine_onecycle_schedule(max(total, 16), max_lr,
  pct_start)`` as optax evaluates it (not ``OneCycleLR``, whose phase ends,
  momentum cycling and total differ);
- the clip is optax's ``clip_by_global_norm(1.0)``: grads scale by
  ``1 / norm`` only when ``norm >= 1`` (``clip_grad_norm_`` divides by
  ``norm + 1e-6``);
- Adam is ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8), which is
  optax's ``scale_by_adam`` with ``eps_root`` 0; update ``t`` (from 0) runs
  at ``schedule(t)``.

Every step (forward and backward) runs in full float32 (``exact_float32``):
the SSIM filters and the float32 convs need it, and bfloat16 convs ignore
the settings.

Checkpoints are pickles of numpy arrays only: ``params`` and the EMA in the
JAX package's ``{name: {'w': HWIO, 'b'}}`` layout (so the JAX package's
``load_init_params`` warm-starts from them), Adam's moments in the same
layout and its step count, ``epoch`` and ``step``. A JAX checkpoint pickles
optax's state objects and is refused with a pointer to ``.tza`` export,
which both packages read and write.

``mesh`` (a ``parallel.mesh.Mesh``, :func:`make_mesh`) runs the host-fed
trainer data-parallel, as the JAX trainer's ``dp`` axis does, and computes
the same function: the loss of the whole batch. The batch splits evenly
over the mesh's devices; each runs its shard's forward on a replica of the
master weights made by a differentiable ``.to(device)``, returns the sums
behind the loss's batch means (``losses.loss_sums``), and the first device
forms the whole batch's means and the loss from them; one backward sums the
replicas' gradients onto the master, where the clip, Adam and the schedule
run as on one device. (Averaging the shards' losses or gradients would
compute another function wherever the loss is not linear in its means.)
``train_device`` stays on one device, as in the JAX package. Every entry
point runs on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import pickle
import time

import numpy as np
import torch

from ..denoise import color
from ..denoise.tza import read_tza
from ..denoise.unet import (UNet, init_unet_tensors, jax_tree, no_tf32, params_from_jax,
                            params_to_jax, unet_train_apply)
from ..ops import rng
from ..parallel import mesh as mesh_mod
from .dataset import TileDataset, ValidationDataset
from .losses import get_loss_function, loss_from_means, loss_sums

PATIENCE = 8  # validations without improvement before an early stop (train_device)
DIVERGENCE = 50.0  # an epoch loss this many times the first one reverts the run


@dataclasses.dataclass
class TrainConfig:
    """Defaults follow training/config.py: 2000 epochs, bs 16, 256^2 tiles,
    l1_msssim loss, mixed precision. The fields, and so ``config.json``,
    are the JAX package's."""

    data_dir: str = ""
    # Validation pairs directory (a fixed tile grid, evaluated every
    # valid_epochs). Empty: <data_dir>/valid where it exists, else none.
    valid_dir: str = ""
    result_dir: str = "results/rt"
    in_channels: int = 6  # color + albedo
    loss: str = "l1_msssim"
    num_epochs: int = 2000
    steps_per_epoch: int = 32
    batch_size: int = 16
    tile_size: int = 256
    max_lr: float = 2e-4
    warmup_pct: float = 0.15
    precision: str = "mixed"  # 'mixed' (bf16 compute) or 'float32'
    # Transfer applied to the color channels before the net; it must match
    # the runtime filter's input packing ('srgb' for LDR RT, 'pu' for HDR).
    transfer: str = "srgb"
    hdr: bool = False  # HDR color range (clamp to +inf instead of 1)
    snorm: bool = False  # signed-normalized input/target (normal prefilter)
    seed: int = 42
    save_epochs: int = 10
    valid_epochs: int = 10
    # Warm start: a checkpoint .pkl or an exported .tza whose params start
    # training when result_dir has no checkpoint of its own (fresh
    # optimizer and schedule).
    init_from: str = ""
    # Per-step exponential moving average of the params (0: off). When on,
    # validation, best-valid selection and the result use the average
    # (train_device only, as in the JAX package).
    ema: float = 0.0

    def check_compatible(self, other: dict):
        """Config mismatch detection on resume (train.py:68-99)."""
        for key in ("in_channels", "loss", "tile_size", "precision"):
            if other.get(key) != getattr(self, key):
                raise ValueError(
                    f"config mismatch on resume: {key} {other.get(key)} != {getattr(self, key)}"
                )


@contextlib.contextmanager
def exact_float32():
    """``no_tf32()`` (the card's cuDNN convs and matmuls in IEEE float32),
    and on the CPU the native convolutions instead of oneDNN's, whose
    float32 backward loses up to ~4e-4 of the largest weight gradient of the
    U-Net (PyTorch 2.13 on an x86 CPU, against 3e-7 for the native ones and
    for XLA, both held against float64)."""
    with no_tf32(), torch.backends.mkldnn.flags(enabled=False):
        yield


def make_mesh(num_devices: int | None = None, devices=None) -> mesh_mod.Mesh:
    """A 1-D "dp" mesh over the first ``num_devices`` devices (default:
    every visible CUDA device; ``devices`` names others)."""
    return mesh_mod.make_mesh(num_devices, "dp", devices)


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, not {type(mesh).__name__}")


def _one_device(net: UNet) -> mesh_mod.Mesh:
    """The mesh of the net's own device: one device, one shard."""
    return mesh_mod.Mesh((next(net.parameters()).device,))


def _shard_outputs(net: UNet, mesh, x, y, preprocess, dtype):
    """Per device of ``mesh``, in order: the net's output on that device's
    shard of the batch (x, y) and the shard's preprocessed target. The
    forward runs on a replica of the net's weights made by a differentiable
    ``.to(device)`` (the weights themselves on their own device), so one
    backward sums the replicas' gradients onto the master."""
    params = dict(net.named_parameters())
    for device, (b0, count) in zip(mesh.devices, mesh_mod.split(x.shape[0], mesh)):
        xd, yd = preprocess(x[b0:b0 + count].to(device), y[b0:b0 + count].to(device))
        replica = {k: p.to(device) for k, p in params.items()}
        pred = torch.func.functional_call(net, replica, (xd.to(dtype).permute(0, 3, 1, 2),))
        yield pred.permute(0, 2, 3, 1).float(), yd


def mesh_loss(cfg: TrainConfig, net: UNet, mesh, x, y, preprocess, dtype):
    """The loss of the whole batch (x, y) split over ``mesh``: per device
    the sums behind the loss's means on its shard (``losses.loss_sums``),
    gathered on the first device, where the whole batch's means form the
    loss. One device is the mesh :func:`_one_device`."""
    totals, h, w = None, int(y.shape[1]), int(y.shape[2])
    for pred, yd in _shard_outputs(net, mesh, x, y, preprocess, dtype):
        sums = [(total.to(mesh.first), count) for total, count in loss_sums(cfg.loss, pred, yd)]
        totals = sums if totals is None else [
            (a + b, m + n) for (a, m), (b, n) in zip(totals, sums)]
    return loss_from_means(cfg.loss, [total / count for total, count in totals], h, w)


# ---- checkpoints ---------------------------------------------------------------


class _NumpyUnpickler(pickle.Unpickler):
    """Loads pickles of builtins and numpy arrays only; anything else (a JAX
    checkpoint's optax state) raises."""

    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise ValueError(
            f"{self.path} is not a checkpoint of this package: it pickles {module}.{name} "
            "(a JAX package checkpoint, which needs optax to load). Export its params to "
            ".tza with the JAX package's train/export.py::export_weights and pass the .tza")


def _load_pickle(path: str):
    with open(path, "rb") as f:
        unpickler = _NumpyUnpickler(f)
        unpickler.path = path
        return unpickler.load()


def _checkpoint_path(result_dir: str, epoch: int) -> str:
    return os.path.join(result_dir, f"checkpoint_{epoch}.pkl")


def save_checkpoint(result_dir, epoch, step, params, opt_state, cfg: TrainConfig,
                    ema_params=None):
    """Pickle ``params``, ``opt_state`` (``Optimizer.state``) and the EMA,
    numpy trees, as ``checkpoint_<epoch>.pkl``; write ``config.json``."""
    os.makedirs(result_dir, exist_ok=True)
    state = {"epoch": epoch, "step": step, "params": params, "opt_state": opt_state}
    if ema_params is not None:
        state["ema_params"] = ema_params
    with open(_checkpoint_path(result_dir, epoch), "wb") as f:
        pickle.dump(state, f)
    with open(os.path.join(result_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def latest_checkpoint(result_dir: str):
    """The checkpoint of the highest epoch in ``result_dir``, or None."""
    if not os.path.isdir(result_dir):
        return None
    epochs = [int(fn[len("checkpoint_"):-len(".pkl")]) for fn in os.listdir(result_dir)
              if fn.startswith("checkpoint_") and fn.endswith(".pkl")]
    if not epochs:
        return None
    return _load_pickle(_checkpoint_path(result_dir, max(epochs)))


def load_init_params(path: str) -> dict:
    """Warm-start params from a checkpoint pickle of this package or an
    exported .tza (exactly the trained params: export is lossless)."""
    if path.endswith(".tza"):
        return params_to_jax(UNet.from_tza(read_tza(path)))
    return _load_pickle(path)["params"]


def init_params(in_channels: int, seed: int) -> dict:
    """He-initialized params from the port's own seeded init
    (``init_unet_tensors``; the JAX package's init draws other numbers)."""
    return params_to_jax(UNet.from_tza(init_unet_tensors(in_channels, seed=seed)))


def _resume(cfg: TrainConfig):
    """(params, checkpoint or None, start epoch): the result dir's latest
    checkpoint (after the config check), else ``init_from``, else the init."""
    ckpt = latest_checkpoint(cfg.result_dir)
    if ckpt is not None:
        cfg_path = os.path.join(cfg.result_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg.check_compatible(json.load(f))
        return ckpt["params"], ckpt, ckpt["epoch"]
    if cfg.init_from and os.path.exists(cfg.init_from):
        # fine-tune warm start: previous round's params, fresh optimizer
        return load_init_params(cfg.init_from), None, 0
    return init_params(cfg.in_channels, cfg.seed), None, 0


def _load_tree(net: UNet, tree: dict, dst=lambda p: p) -> None:
    """Copy a ``{name: {'w': HWIO, 'b'}}`` tree into ``dst(parameter)`` of
    every conv of ``net``."""
    with torch.no_grad():
        for name, conv in net.convs.items():
            dst(conv.weight).copy_(torch.from_numpy(
                np.transpose(np.asarray(tree[name]["w"], np.float32), (3, 2, 0, 1)).copy()))
            dst(conv.bias).copy_(torch.from_numpy(np.asarray(tree[name]["b"], np.float32)))


# ---- the optimizer ------------------------------------------------------------------


def onecycle_schedule(total_steps: int, peak_value: float, pct_start: float = 0.15,
                      div_factor: float = 25.0, final_div_factor: float = 1e4):
    """``optax.cosine_onecycle_schedule(max(total_steps, 16), peak_value,
    pct_start)`` as a function of the step, computed as optax computes it:
    the phase position in float64, the cosine and the interpolation in
    float32. The floor of 16 keeps the warm-up phase from having zero
    width (optax divides by it and returns NaN)."""
    transition = max(total_steps, 16)
    bounds = (0, int(pct_start * transition), int(transition))
    values = np.cumprod([peak_value / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])

    def schedule(count: int) -> float:
        for k in range(2):
            if bounds[k] <= count < bounds[k + 1]:
                pct = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
                cos = np.float32(math.cos(float(np.float32(math.pi * pct))))
                half = np.float32((values[k] - values[k + 1]) / 2.0)
                return float(np.float32(values[k + 1]) + half * (cos + np.float32(1.0)))
        return float(np.float32(values[-1]))

    return schedule


class Optimizer:
    """``optax.chain(clip_by_global_norm(1.0), adam(schedule))`` over a net's
    parameters; ``count`` is the number of updates applied."""

    def __init__(self, net: UNet, schedule):
        self.net = net
        self.params = list(net.parameters())
        self.schedule = schedule
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def step(self) -> None:
        """Clip the grads as optax does, then one Adam update at
        ``schedule(count)``."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_div_(grads, torch.where(norm < 1.0, 1.0, norm))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state(self) -> dict:
        """Adam's moments (``mu``, ``nu``) in the params' layout and ``count``."""
        moment = lambda key: lambda p: self.adam.state.get(p, {}).get(key, torch.zeros_like(p))
        return {"count": self.count, "mu": jax_tree(self.net, moment("exp_avg")),
                "nu": jax_tree(self.net, moment("exp_avg_sq"))}

    def load_state(self, state: dict) -> None:
        self.count = int(state["count"])
        for p in self.params:
            self.adam.state[p] = {"step": torch.tensor(float(self.count)),
                                  "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.zeros_like(p)}
        _load_tree(self.net, state["mu"], lambda p: self.adam.state[p]["exp_avg"])
        _load_tree(self.net, state["nu"], lambda p: self.adam.state[p]["exp_avg_sq"])


class Ema:
    """Per-step exponential moving average of a net's params, held in a copy
    of the net (``e * d + p * (1 - d)`` in float32, as the JAX trainer)."""

    def __init__(self, net: UNet, decay: float):
        self.net = copy.deepcopy(net)
        self.d = float(np.float32(decay))
        self.one_minus_d = float(np.float32(1.0) - np.float32(decay))

    def update(self, params) -> None:
        with torch.no_grad():
            avg = list(self.net.parameters())
            torch._foreach_mul_(avg, self.d)
            torch._foreach_add_(avg, torch._foreach_mul(list(params), self.one_minus_d))


def _make_optimizer(cfg: TrainConfig, net: UNet) -> Optimizer:
    return Optimizer(net, onecycle_schedule(cfg.num_epochs * cfg.steps_per_epoch, cfg.max_lr,
                                            cfg.warmup_pct))


# ---- steps ------------------------------------------------------------------------


def make_preprocess(cfg: TrainConfig):
    """The runtime's input packing (input_reorder.ispc) on NHWC tensors:
    color sanitized to [0, 1] (HDR: [0, inf) and, per crop, scaled by the
    target's autoexposure) and transfer-encoded; albedo clamped; normals
    snorm-shifted; the target encoded as the color. ``snorm`` is the
    normal prefilter's convention (rt_nrm: [-1, 1] -> [0, 1], linear)."""
    tf = color.make_transfer(cfg.transfer)

    def preprocess(x, y):
        if cfg.snorm:
            col = color.sanitize(x[..., :3], -1.0, 1.0) * 0.5 + 0.5
            y = color.sanitize(y, -1.0, 1.0) * 0.5 + 0.5
            return col, y
        hi = math.inf if cfg.hdr else 1.0
        xc = color.sanitize(x[..., :3], 0.0, hi)
        y = color.sanitize(y, 0.0, hi)
        if cfg.hdr:
            # One exposure per crop, from its target (the reference computes
            # one per full target image at preprocess time): the runtime
            # serves the net behind the same normalization.
            exp_scale = color.autoexposure(y)[:, None, None, None]
            xc = xc * exp_scale
            y = y * exp_scale
        parts = [tf.forward(xc)]
        if cfg.in_channels >= 6:
            parts.append(color.sanitize(x[..., 3:6], 0.0, 1.0))  # albedo
        if cfg.in_channels >= 9:
            parts.append(color.sanitize(x[..., 6:9], -1.0, 1.0) * 0.5 + 0.5)  # normals
        return torch.cat(parts, dim=-1), tf.forward(y)

    return preprocess


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "mixed" else torch.float32


def build_train_step(cfg: TrainConfig, optimizer: Optimizer, mesh=None):
    """(step_fn, mesh): ``step_fn(x, y)`` takes one NHWC batch on the net's
    device, applies one update and returns the loss before it (a 0-d
    device tensor; nothing is read back to the host). With ``mesh`` the
    batch splits evenly over its devices (ValueError if it does not); the
    loss is the whole batch's (:func:`mesh_loss`) either way, on the
    mesh's first device."""
    _check_mesh(mesh)
    dtype = _compute_dtype(cfg)
    preprocess = make_preprocess(cfg)
    net = optimizer.net
    shards = mesh or _one_device(net)

    def step_fn(x, y):
        with exact_float32():
            loss = mesh_loss(cfg, net, shards, x, y, preprocess, dtype)
            optimizer.adam.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step_fn, mesh


def build_eval_step(cfg: TrainConfig, mesh=None):
    """``eval_fn(net, x, y)``: per-example validation losses [B] (no grad),
    so the caller can weight out the tiles that pad the last batch. With
    ``mesh`` each device takes its shard of the batch and the losses are
    concatenated in order on the first device."""
    _check_mesh(mesh)
    loss_fn = get_loss_function(cfg.loss)
    dtype = _compute_dtype(cfg)
    preprocess = make_preprocess(cfg)

    def eval_fn(net, x, y):
        shards = mesh or _one_device(net)
        with torch.no_grad(), exact_float32():
            return torch.cat([
                torch.stack([loss_fn(pred[b:b + 1], yd[b:b + 1])
                             for b in range(pred.shape[0])]).to(shards.first)
                for pred, yd in _shard_outputs(net, shards, x, y, preprocess, dtype)])

    return eval_fn


def validate(cfg: TrainConfig, net: UNet, valid_ds: ValidationDataset, eval_fn) -> float:
    """Mean loss over the validation tile grid (training/train.py:228-269)."""
    device = next(net.parameters()).device
    total, count = 0.0, 0
    for x, y, k in valid_ds.batches(cfg.batch_size):
        if x.shape[-1] > cfg.in_channels:
            x = x[..., : cfg.in_channels]
        losses = eval_fn(net, torch.from_numpy(np.ascontiguousarray(x)).to(device),
                         torch.from_numpy(y).to(device)).cpu().numpy()
        total += float(losses[:k].sum())
        count += k
    return total / max(count, 1)


def _validation(cfg: TrainConfig, mesh=None):
    valid_dir = cfg.valid_dir or os.path.join(cfg.data_dir, "valid")
    if os.path.isdir(valid_dir):
        try:
            return ValidationDataset(valid_dir, cfg.tile_size), build_eval_step(cfg, mesh)
        except ValueError:
            pass
    return None, None


def draw_crops(key, steps: int, batch: int, poses: int, rows: int, cols: int) -> torch.Tensor:
    """An epoch's crops as ``jax.random`` draws them in the JAX trainer's
    ``make_batch``: step ``s`` uses key ``s`` of ``split(key, steps)``, split
    four ways into the pose in [0, poses), the row and column offsets in
    [0, rows) and [0, cols), and three fair flips (x, y, transpose).
    Returns int64 [steps, batch, 6] (pose, row, col, fx, fy, ft)."""
    w0, w1 = rng.split_words(key, steps)
    q0, q1 = rng.split_words((w0, w1), 4)
    sub = lambda n: (q0[:, n], q1[:, n])
    p = rng.randint_shaped(sub(0), (batch,), 0, poses)
    i = rng.randint_shaped(sub(1), (batch,), 0, rows)
    j = rng.randint_shaped(sub(2), (batch,), 0, cols)
    flips = rng.bernoulli(sub(3), 0.5, (batch, 3)).long()
    return torch.cat([p[..., None], i[..., None], j[..., None], flips], dim=-1)


def crop_batch(imgs: torch.Tensor, crops: torch.Tensor, tile: int) -> torch.Tensor:
    """``imgs`` [P, H, W, C] cropped at ``crops`` [B, 6] (one step of
    :func:`draw_crops`) with the dihedral flips folded into one gather:
    [B, tile, tile, C], element for element the JAX trainer's
    ``dynamic_slice`` then x-flip, y-flip, transpose."""
    ar = torch.arange(tile, device=imgs.device)
    u, v = ar[:, None], ar[None, :]
    p, i, j, fx, fy, ft = (crops[:, k, None, None] for k in range(6))
    a = torch.where(ft.bool(), v, u)
    b = torch.where(ft.bool(), u, v)
    r = i + torch.where(fy.bool(), tile - 1 - a, a)
    c = j + torch.where(fx.bool(), tile - 1 - b, b)
    return imgs[p, r, c]


def build_epoch_fn(cfg: TrainConfig, optimizer: Optimizer, ema: Ema | None = None):
    """``epoch_fn(key, x_imgs, y_imgs)``: one epoch of ``steps_per_epoch``
    updates on crops of the device-resident images (x [P, H, W, >= C],
    y [P, H, W, 3]); returns the mean loss as a 0-d device tensor.

    The JAX trainer runs the epoch as one ``lax.scan``; here the steps are a
    Python loop, but the crops are drawn up front (:func:`draw_crops`, the
    same numbers as JAX's) and copied to the device once, every crop is a
    gather on the device, and the losses stay there: the host reads nothing
    during the epoch."""
    step_fn, _ = build_train_step(cfg, optimizer)
    tile, steps = cfg.tile_size, cfg.steps_per_epoch

    def epoch_fn(key, x_imgs, y_imgs):
        poses, h, w, _ = x_imgs.shape
        crops = draw_crops(key, steps, cfg.batch_size, poses, h - tile + 1, w - tile + 1)
        if x_imgs.device.type == "cuda":
            crops = crops.pin_memory().to(x_imgs.device, non_blocking=True)
        x_imgs = x_imgs[..., : cfg.in_channels]
        losses = []
        for s in range(steps):
            losses.append(step_fn(crop_batch(x_imgs, crops[s], tile),
                                  crop_batch(y_imgs, crops[s], tile)))
            if ema is not None:
                ema.update(optimizer.params)
        return torch.stack(losses).mean()

    return epoch_fn


# ---- the trainers ------------------------------------------------------------------


def _append_log(path: str, rec: dict, log_fn) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    if log_fn:
        log_fn(rec)


def train_device(cfg: TrainConfig, x_imgs, y_imgs, log_fn=None, device="cuda") -> dict:
    """train(), with the dataset resident in device memory.

    ``x_imgs`` [P, H, W, Cx >= in_channels] and ``y_imgs`` [P, H, W, 3] are
    copied to the device once. Checkpoints, resume and validation match
    train(); besides, the EMA (``cfg.ema``), best-valid selection kept in
    ``best.pkl``, an early stop after ``PATIENCE`` validations without
    improvement, and the divergence guard. Returns the params (the best
    valid ones where validation ran) as a ``{name: {'w', 'b'}}`` numpy tree."""
    device = torch.device(device)
    x_imgs = torch.as_tensor(np.asarray(x_imgs, np.float32)).to(device)
    y_imgs = torch.as_tensor(np.asarray(y_imgs, np.float32)).to(device)
    params, ckpt, start_epoch = _resume(cfg)
    net = params_from_jax(params).to(device)
    optimizer = _make_optimizer(cfg, net)
    if ckpt is not None:
        optimizer.load_state(ckpt["opt_state"])

    use_ema = cfg.ema > 0.0
    # The EMA starts at the current weights (a zero start needs a long
    # bias-correction burn-in); a resume restores the saved average.
    ema = Ema(net, cfg.ema) if use_ema else None
    if ema is not None and ckpt is not None and ckpt.get("ema_params") is not None:
        _load_tree(ema.net, ckpt["ema_params"])
    eval_net = ema.net if use_ema else net

    epoch_fn = build_epoch_fn(cfg, optimizer, ema)
    valid_ds, eval_fn = _validation(cfg)
    log_path = os.path.join(cfg.result_dir, "log.jsonl")
    os.makedirs(cfg.result_dir, exist_ok=True)
    base_key = rng.make_key(cfg.seed)

    step = start_epoch * cfg.steps_per_epoch
    first_loss = None
    # Best-valid state persists in best.pkl, so a resume that runs no epoch
    # still returns the best params, not the last checkpoint's.
    best_path = os.path.join(cfg.result_dir, "best.pkl")
    best_valid, best_params, stale = np.inf, None, 0
    if os.path.exists(best_path):
        prev = _load_pickle(best_path)
        best_valid = prev.get("valid_loss", np.inf)
        best_params = prev.get("params")
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        mean_loss = epoch_fn(rng.fold_in(base_key, epoch), x_imgs, y_imgs)
        step += cfg.steps_per_epoch
        loss_val = float(mean_loss)  # the epoch's one read from the device
        if first_loss is None and np.isfinite(loss_val):
            first_loss = max(loss_val, 1e-6)
        # Divergence guard: revert to the last checkpoint and stop; a
        # relaunch with a lower max_lr resumes from it.
        if not np.isfinite(loss_val) or (first_loss is not None
                                         and loss_val > DIVERGENCE * first_loss):
            ckpt = latest_checkpoint(cfg.result_dir)
            _append_log(log_path, {"epoch": epoch + 1, "diverged": True, "loss": loss_val,
                                   "reverted_to": ckpt["epoch"] if ckpt else None}, log_fn)
            if ckpt is not None:
                _load_tree(net, ckpt["params"])
                if ema is not None:
                    saved = ckpt.get("ema_params")
                    _load_tree(ema.net, ckpt["params"] if saved is None else saved)
            break
        rec = {
            "epoch": epoch + 1,
            "step": step,
            "loss": loss_val,
            "lr": optimizer.schedule(step),
            "images_per_sec": cfg.steps_per_epoch * cfg.batch_size / (time.time() - t0),
        }
        if valid_ds is not None and (
            (epoch + 1) % cfg.valid_epochs == 0 or epoch + 1 == cfg.num_epochs
        ):
            vl = validate(cfg, eval_net, valid_ds, eval_fn)
            rec["valid_loss"] = vl
            # Keep the best-valid params and stop after PATIENCE checks
            # without improvement: a warm-started fine-tune can overfit
            # monotonically, and exporting its last params would regress.
            if np.isfinite(vl) and vl < best_valid:
                best_valid, best_params, stale = vl, params_to_jax(eval_net), 0
                with open(best_path, "wb") as f:
                    pickle.dump({"params": best_params, "valid_loss": vl, "epoch": epoch + 1}, f)
            else:
                stale += 1
        _append_log(log_path, rec, log_fn)
        if (epoch + 1) % cfg.save_epochs == 0 or epoch + 1 == cfg.num_epochs:
            save_checkpoint(cfg.result_dir, epoch + 1, step, params_to_jax(net), optimizer.state(),
                            cfg, ema_params=params_to_jax(ema.net) if use_ema else None)
        if stale >= PATIENCE:
            _append_log(log_path, {"epoch": epoch + 1, "early_stop": True, "loss": loss_val,
                                   "best_valid": best_valid}, log_fn)
            break
    if best_params is not None:
        return best_params
    return params_to_jax(eval_net)


def train(cfg: TrainConfig, mesh=None, log_fn=None, device="cuda") -> dict:
    """Run training with batches from the host's TileDataset; auto-resumes
    from result_dir. Returns the final params as a numpy tree. With
    ``mesh`` every batch splits over its devices (:func:`build_train_step`)
    and the master weights live on its first device (``device`` is not
    used)."""
    _check_mesh(mesh)
    device = mesh.first if mesh is not None else torch.device(device)
    dataset = TileDataset(cfg.data_dir, cfg.tile_size, seed=cfg.seed)
    params, ckpt, start_epoch = _resume(cfg)
    net = params_from_jax(params).to(device)
    optimizer = _make_optimizer(cfg, net)
    if ckpt is not None:
        optimizer.load_state(ckpt["opt_state"])
    step_fn, _ = build_train_step(cfg, optimizer, mesh)
    valid_ds, eval_fn = _validation(cfg, mesh)
    log_path = os.path.join(cfg.result_dir, "log.jsonl")
    os.makedirs(cfg.result_dir, exist_ok=True)

    step = start_epoch * cfg.steps_per_epoch
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        losses = []
        for _ in range(cfg.steps_per_epoch):
            x, y = dataset.sample_batch(cfg.batch_size)
            if x.shape[-1] > cfg.in_channels:
                x = x[..., : cfg.in_channels]  # e.g. color only from color + albedo pairs
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            losses.append(step_fn(x, torch.from_numpy(y).to(device)))
            step += 1
        rec = {
            "epoch": epoch + 1,
            "step": step,
            "loss": float(torch.stack(losses).mean()),
            "lr": optimizer.schedule(step),
            "images_per_sec": cfg.steps_per_epoch * cfg.batch_size / (time.time() - t0),
        }
        if valid_ds is not None and (
            (epoch + 1) % cfg.valid_epochs == 0 or epoch + 1 == cfg.num_epochs
        ):
            rec["valid_loss"] = validate(cfg, net, valid_ds, eval_fn)
        _append_log(log_path, rec, log_fn)
        if (epoch + 1) % cfg.save_epochs == 0 or epoch + 1 == cfg.num_epochs:
            save_checkpoint(cfg.result_dir, epoch + 1, step, params_to_jax(net), optimizer.state(),
                            cfg)
    return params_to_jax(net)
