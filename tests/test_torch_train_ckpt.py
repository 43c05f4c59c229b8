"""The port's checkpoints, resume, EMA, divergence guard, early stop,
best-valid selection and validation weighting, on the CPU at small sizes
(tiles of 16-32, batch 1-4, loss l1, float32). Mirrors the behaviour of
``mygpuraytracer_tpu/train/train.py`` (tests/test_train.py:95-187 and
train.py:403-486). Equalities here are bit for bit (one device, one
order of operations) except the padded-batch weighting, rtol 1e-5 (the
sums run over other batch splits)."""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.train.dataset import ValidationDataset
from mygpuraytracer_tpu_torch.train.train import (PATIENCE, TrainConfig, build_eval_step,
                                                  init_params, latest_checkpoint, train,
                                                  train_device, validate)
from mygpuraytracer_tpu_torch.denoise.unet import params_from_jax

train_mod = sys.modules["mygpuraytracer_tpu_torch.train.train"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pairs(d, n=2, size=48, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    g = np.random.default_rng(seed)
    for i in range(n):
        np.save(d / f"s{i}.input.npy", g.random((size, size, 6), np.float32))
        np.save(d / f"s{i}.target.npy", g.random((size, size, 3), np.float32))
    return str(d)


def _images(seed=1, n=3, size=40):
    g = np.random.default_rng(seed)
    return g.random((n, size, size, 6), np.float32), g.random((n, size, size, 3), np.float32)


def _cfg(tmp_path, **kw):
    base = dict(data_dir=str(tmp_path / "data"), result_dir=str(tmp_path / "result"),
                in_channels=6, loss="l1", num_epochs=2, steps_per_epoch=2, batch_size=1,
                tile_size=16, precision="float32", save_epochs=1, valid_epochs=1)
    return TrainConfig(**{**base, **kw})


def _log(cfg):
    return [json.loads(line) for line in open(os.path.join(cfg.result_dir, "log.jsonl"))]


def _equal(a, b):
    return all(np.array_equal(a[k][w], b[k][w]) for k in a for w in ("w", "b"))


def test_host_fed_resume_continues(tmp_path):
    _pairs(tmp_path / "data")
    cfg = _cfg(tmp_path)
    train(cfg, device="cpu")
    assert latest_checkpoint(cfg.result_dir)["epoch"] == 2
    cfg3 = _cfg(tmp_path, num_epochs=3)
    train(cfg3, device="cpu")
    ckpt = latest_checkpoint(cfg.result_dir)
    assert (ckpt["epoch"], ckpt["step"], ckpt["opt_state"]["count"]) == (3, 6, 6)
    assert [r["epoch"] for r in _log(cfg)] == [1, 2, 3]


def test_device_resume_equals_uninterrupted(tmp_path):
    """Crops are drawn from fold_in(key(seed), epoch) and Adam's state is in
    the checkpoint, so a run resumed after epoch 2 ends where the
    uninterrupted run ends."""
    x, y = _images()
    cfg = _cfg(tmp_path, num_epochs=3, data_dir=str(tmp_path))
    straight = train_device(cfg, x, y, device="cpu")
    os.remove(os.path.join(cfg.result_dir, "checkpoint_3.pkl"))
    resumed = train_device(cfg, x, y, device="cpu")
    assert _equal(straight, resumed)
    assert _equal(resumed, latest_checkpoint(cfg.result_dir)["params"])


def test_config_mismatch_raises(tmp_path):
    x, y = _images()
    cfg = _cfg(tmp_path, num_epochs=1, data_dir=str(tmp_path))
    train_device(cfg, x, y, device="cpu")
    other = _cfg(tmp_path, num_epochs=2, data_dir=str(tmp_path), loss="l2")
    with pytest.raises(ValueError, match="config mismatch on resume: loss"):
        train_device(other, x, y, device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        TrainConfig(in_channels=6).check_compatible(
            {"in_channels": 9, "loss": "l1_msssim", "tile_size": 256, "precision": "mixed"})


def test_ema_checkpointed_returned_and_resumed(tmp_path):
    x, y = _images(2)
    cfg = _cfg(tmp_path, data_dir=str(tmp_path), ema=0.9)
    out = train_device(cfg, x, y, device="cpu")
    ckpt = latest_checkpoint(cfg.result_dir)
    assert ckpt["epoch"] == 2 and "ema_params" in ckpt
    assert not _equal(ckpt["ema_params"], ckpt["params"])  # the average lags the iterate
    assert _equal(out, ckpt["ema_params"])
    cfg.num_epochs = 3
    train_device(cfg, x, y, device="cpu")
    assert latest_checkpoint(cfg.result_dir)["epoch"] == 3


def test_divergence_guard_reverts(tmp_path, monkeypatch):
    x, y = _images(3)
    cfg = _cfg(tmp_path, num_epochs=4, data_dir=str(tmp_path))
    real = train_mod.build_epoch_fn

    def diverging(cfg_, optimizer, ema=None):
        epoch_fn = real(cfg_, optimizer, ema)
        calls = []

        def run(key, xi, yi):
            loss = epoch_fn(key, xi, yi)
            calls.append(1)
            if len(calls) == 2:  # the second epoch blows up
                with torch.no_grad():
                    for p in optimizer.params:
                        p.fill_(1e6)
                return torch.tensor(1e9)
            return loss

        return run

    monkeypatch.setattr(train_mod, "build_epoch_fn", diverging)
    out = train_device(cfg, x, y, device="cpu")
    log = _log(cfg)
    assert log[-1] == {"epoch": 2, "diverged": True, "loss": 1e9, "reverted_to": 1}
    assert _equal(out, latest_checkpoint(cfg.result_dir)["params"])
    assert latest_checkpoint(cfg.result_dir)["epoch"] == 1


def test_divergence_on_nan_without_checkpoint(tmp_path, monkeypatch):
    x, y = _images(3)
    cfg = _cfg(tmp_path, num_epochs=3, data_dir=str(tmp_path), save_epochs=10)
    monkeypatch.setattr(train_mod, "build_epoch_fn",
                        lambda *a, **k: (lambda key, xi, yi: torch.tensor(float("nan"))))
    train_device(cfg, x, y, device="cpu")
    rec = _log(cfg)[-1]
    assert rec["diverged"] and rec["reverted_to"] is None and np.isnan(rec["loss"])


def test_early_stop_and_best_returned(tmp_path, monkeypatch):
    """The first validation is the best; PATIENCE stale ones stop the run,
    and the best-valid params (kept in best.pkl) are returned, also by a
    resume that runs no epoch."""
    x, y = _images(4)
    _pairs(tmp_path / "data" / "valid", n=1, size=32)
    cfg = _cfg(tmp_path, num_epochs=20, steps_per_epoch=1)
    values = iter([1.0] + [2.0] * 30)
    seen = []

    def fake_validate(cfg_, net, valid_ds, eval_fn):
        seen.append({k: v.detach().clone() for k, v in net.state_dict().items()})
        return next(values)

    monkeypatch.setattr(train_mod, "validate", fake_validate)
    out = train_device(cfg, x, y, device="cpu")
    log = _log(cfg)
    assert log[-1] == {"epoch": 1 + PATIENCE, "early_stop": True, "loss": log[-2]["loss"],
                       "best_valid": 1.0}
    assert [r.get("valid_loss") for r in log[:-1]] == [1.0] + [2.0] * PATIENCE
    with open(os.path.join(cfg.result_dir, "best.pkl"), "rb") as f:
        best = pickle.load(f)
    assert best["epoch"] == 1 and best["valid_loss"] == 1.0
    assert _equal(out, best["params"])
    first = params_from_jax(out).state_dict()
    assert all(torch.equal(first[k], seen[0][k]) for k in first)
    assert not _equal(out, latest_checkpoint(cfg.result_dir)["params"])
    # a resume past num_epochs runs nothing and still returns the best
    cfg.num_epochs = 1
    assert _equal(train_device(cfg, x, y, device="cpu"), best["params"])


def test_validation_logged_on_host_fed_train(tmp_path):
    _pairs(tmp_path / "data", size=48)
    _pairs(tmp_path / "data" / "valid", n=1, size=64)
    cfg = _cfg(tmp_path, tile_size=32, steps_per_epoch=2)
    train(cfg, device="cpu")
    recs = _log(cfg)
    assert len(recs) == 2 and all(np.isfinite(r["valid_loss"]) for r in recs)


def test_validation_padded_batch_weighting(tmp_path):
    """9 tiles in batches of 4 (the last padded with 3 repeats) weigh as 9
    tiles in batches of 3 (tests/test_train.py's case)."""
    _pairs(tmp_path / "v", n=1, size=96)
    cfg = TrainConfig(in_channels=6, loss="l1", batch_size=4, tile_size=32, precision="float32")
    net = params_from_jax(init_params(6, 0))
    vd = ValidationDataset(str(tmp_path / "v"), 32)
    v1 = validate(cfg, net, vd, build_eval_step(cfg))
    cfg3 = TrainConfig(**{**cfg.__dict__, "batch_size": 3})
    v3 = validate(cfg3, net, vd, build_eval_step(cfg3))
    np.testing.assert_allclose(v1, v3, rtol=1e-5)
    per_tile = [float(build_eval_step(cfg)(net, torch.from_numpy(x[None]), torch.from_numpy(t[None]))[0])
                for x, t in vd.tiles()]
    np.testing.assert_allclose(v1, np.mean(per_tile), rtol=1e-5)
