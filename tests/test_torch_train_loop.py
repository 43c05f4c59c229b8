"""The port's host-fed ``train()`` and device-resident ``train_device()``
against the JAX package's, step for step, on the CPU.

Both sides start from one ``.tza`` that JAX exports from its
``init_unet_params`` (``init_from``), train on ``data/denoise/`` with tiles
of 32, batch 2, 2 epochs of 2 steps, ``float32``, the default
``l1_msssim``. ``train()`` draws its crops from the numpy ``TileDataset``
(bit for bit the same batches); ``train_device()`` from ``jax.random``
keys, which the port draws bit for bit (``ops/rng.py``).

Tolerances: every ``log.jsonl`` record's ``loss`` and ``lr`` rtol 1e-4;
no element of the final params off by more than 2 x the sum of the
learning rates applied (Adam turns a near-zero gradient into +-lr, so a
sign that rounds the other way moves an element by up to 2 lr per step: a
rounding matter, not a fault); for ``train_device()`` besides, atol 1e-6
on at least 99.9% of the elements. ``train()``'s batches from
``data/denoise/`` include all-black crops of the sphere scenes, on which
the JAX step's own float32 gradients lie up to 2.3e-3 x the largest
gradient from a float64 evaluation (the port's: 2.9e-6 x, held in
``test_torch_train_step.py::test_float32_step_on_a_black_crop``), and Adam
spreads that over ~17% of the elements within the 2 x lr bound.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu.denoise.unet import init_unet_params
from mygpuraytracer_tpu.train.export import export_weights as jax_export
from mygpuraytracer_tpu.train.train import TrainConfig as JaxTrainConfig
from mygpuraytracer_tpu.train.train import train as jax_train
from mygpuraytracer_tpu.train.train import train_device as jax_train_device

from mygpuraytracer_tpu_torch.train.train import (TrainConfig, latest_checkpoint,
                                                  onecycle_schedule, train, train_device)

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "data" / "denoise"
LOG_RTOL = 1e-4
PARAM_ATOL = 1e-6
PARAM_SHARE = 0.999


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def init_tza(tmp_path_factory):
    path = tmp_path_factory.mktemp("init") / "init.tza"
    jax_export(init_unet_params(6, seed=11), str(path))
    return str(path)


def _cfg(cls, result_dir, init_from, **kw):
    return cls(data_dir=str(DATA), result_dir=str(result_dir), in_channels=6, num_epochs=2,
               steps_per_epoch=2, batch_size=2, tile_size=32, precision="float32",
               save_epochs=1, init_from=init_from, seed=3, **kw)


def _log(result_dir):
    return [json.loads(line) for line in open(pathlib.Path(result_dir) / "log.jsonl")]


def _compare(tmp_path, ours, theirs, cfg, share=True):
    got_log, want_log = _log(tmp_path / "port"), _log(tmp_path / "jax")
    assert len(got_log) == len(want_log) == cfg.num_epochs
    for g, w in zip(got_log, want_log):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        assert g["loss"] == pytest.approx(w["loss"], rel=LOG_RTOL)
        assert g["lr"] == pytest.approx(w["lr"], rel=LOG_RTOL)
    total = cfg.num_epochs * cfg.steps_per_epoch
    schedule = onecycle_schedule(total, cfg.max_lr, cfg.warmup_pct)
    lr_sum = sum(schedule(t) for t in range(total))
    errs = np.concatenate([np.abs(np.asarray(ours[k][w]) - np.asarray(theirs[k][w])).ravel()
                           for k in theirs for w in ("w", "b")])
    if share:
        assert (errs <= PARAM_ATOL).mean() >= PARAM_SHARE, (errs > PARAM_ATOL).mean()
    assert errs.max() <= 2 * lr_sum, (errs.max(), lr_sum)
    ckpt = latest_checkpoint(str(tmp_path / "port"))
    assert ckpt["epoch"] == cfg.num_epochs and ckpt["step"] == total
    assert ckpt["opt_state"]["count"] == total


def test_train_matches_jax(tmp_path, init_tza):
    cfg = _cfg(TrainConfig, tmp_path / "port", init_tza)
    ours = train(cfg, device="cpu")
    theirs = jax_train(_cfg(JaxTrainConfig, tmp_path / "jax", init_tza))
    _compare(tmp_path, ours, theirs, cfg, share=False)


def _stack():
    names = sorted(p.name[: -len(".input.npy")] for p in DATA.glob("*.input.npy"))
    x = np.stack([np.load(DATA / f"{n}.input.npy") for n in names]).astype(np.float32)
    y = np.stack([np.load(DATA / f"{n}.target.npy") for n in names]).astype(np.float32)
    return x, y


def test_train_device_matches_jax(tmp_path, init_tza):
    x, y = _stack()
    cfg = _cfg(TrainConfig, tmp_path / "port", init_tza)
    ours = train_device(cfg, x, y, device="cpu")
    theirs = jax_train_device(_cfg(JaxTrainConfig, tmp_path / "jax", init_tza), x, y)
    _compare(tmp_path, ours, theirs, cfg)
