"""The port's trained weights, checkpoints, Infer, metrics and LR range
test against the JAX package's, on the CPU.

- ``export_weights``: the bytes of JAX's export of the same params; the
  port's export loads in JAX (``read_tza`` + ``params_from_tza`` +
  ``unet_apply``) and computes the port's forward within 1e-5 x its
  largest |output| (the CPU's oneDNN convolutions in the port's forward
  round differently from XLA's).
- JAX's ``load_init_params`` reads a port checkpoint; a JAX checkpoint
  given to the port raises, naming .tza export.
- ``Infer`` against JAX's on a seeded 40x56 image (srgb, HDR pu, snorm, the
  aux prefilter chain), atol 1e-5; for HDR pu also rtol 1e-4: the pu
  inverse is an exponential, d ln y = dx / (0.319 x 0.193), so the net's
  ~3e-6 rounding becomes ~5e-5 of outputs that a random net drives to
  1e10. ``METRICS`` rtol 1e-6, SSIM atol 1e-6 (a mean near 0 of terms
  near 1 in magnitude).
- ``find_lr`` from one init (both packages' init replaced by the same
  .tza's params): the same lrs, smoothed losses rtol 1e-4.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mygpuraytracer_tpu.denoise.tza import read_tza as jax_read_tza
from mygpuraytracer_tpu.denoise.unet import init_unet_params, params_from_tza, unet_apply
from mygpuraytracer_tpu.train import find_lr as jax_find_lr
from mygpuraytracer_tpu.train.export import export_weights as jax_export
from mygpuraytracer_tpu.train.infer import METRICS as JAX_METRICS
from mygpuraytracer_tpu.train.infer import Infer as JaxInfer
from mygpuraytracer_tpu.train.train import load_init_params as jax_load_init_params
from mygpuraytracer_tpu.train.train import save_checkpoint as jax_save_checkpoint
from mygpuraytracer_tpu.train.train import TrainConfig as JaxTrainConfig

from mygpuraytracer_tpu_torch.denoise.unet import params_from_jax, unet_apply as port_apply
from mygpuraytracer_tpu_torch.train import find_lr as port_find_lr
from mygpuraytracer_tpu_torch.train.export import export_weights, load_checkpoint_params
from mygpuraytracer_tpu_torch.train.infer import METRICS, Infer
from mygpuraytracer_tpu_torch.train.train import (TrainConfig, init_params, load_init_params,
                                                  save_checkpoint, train_device)

FORWARD_RTOL = 1e-5
INFER_ATOL = 1e-5
INFER_HDR_RTOL = 1e-4
LR_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_export_bytes_match_jax(tmp_path):
    params = jax.device_get(init_unet_params(6, seed=2))
    export_weights(params, str(tmp_path / "port.tza"))
    jax_export(params, str(tmp_path / "jax.tza"))
    assert (tmp_path / "port.tza").read_bytes() == (tmp_path / "jax.tza").read_bytes()


def test_port_export_loads_in_jax(tmp_path):
    params = init_params(6, seed=4)  # the port's own init
    path = str(tmp_path / "w.tza")
    export_weights(params, path)
    back = params_from_tza(jax_read_tza(path))
    x = np.random.default_rng(0).random((1, 32, 48, 6), np.float32)
    want = np.asarray(unet_apply(back, jnp.asarray(x)))
    got = port_apply(params_from_jax(params), torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()
    loaded = load_init_params(path)
    assert all(np.array_equal(loaded[k][w], params[k][w]) for k in params for w in ("w", "b"))


def test_jax_reads_a_port_checkpoint(tmp_path):
    g = np.random.default_rng(1)
    x, y = g.random((2, 40, 40, 6), np.float32), g.random((2, 40, 40, 3), np.float32)
    cfg = TrainConfig(data_dir=str(tmp_path), result_dir=str(tmp_path / "r"), loss="l1",
                      num_epochs=1, steps_per_epoch=1, batch_size=1, tile_size=16,
                      precision="float32", save_epochs=1)
    out = train_device(cfg, x, y, device="cpu")
    ckpt_path = str(tmp_path / "r" / "checkpoint_1.pkl")
    theirs = jax_load_init_params(ckpt_path)
    assert all(np.array_equal(np.asarray(theirs[k][w]), out[k][w]) for k in out for w in ("w", "b"))
    want = np.asarray(unet_apply(theirs, jnp.ones((1, 16, 16, 6))))
    got = port_apply(params_from_jax(out), torch.ones((1, 16, 16, 6))).numpy()
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()
    assert all(np.array_equal(load_checkpoint_params(cfg.result_dir)[k][w], out[k][w])
               for k in out for w in ("w", "b"))
    with open(ckpt_path, "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"epoch", "step", "params", "opt_state"}
    assert set(raw["opt_state"]) == {"count", "mu", "nu"}


def test_jax_checkpoint_refused(tmp_path):
    params = init_unet_params(3, seed=0)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jax_save_checkpoint(str(tmp_path), 3, 30, params, opt.init(params), JaxTrainConfig())
    with pytest.raises(ValueError, match=r"not a checkpoint of this package.*\.tza"):
        load_init_params(str(tmp_path / "checkpoint_3.pkl"))
    with pytest.raises(ValueError, match="export_weights"):
        load_checkpoint_params(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_checkpoint_params(str(tmp_path / "empty"))
    # a port checkpoint written beside it with the same numbers loads
    save_checkpoint(str(tmp_path / "p"), 1, 1, jax.device_get(params),
                    {"count": 0, "mu": {}, "nu": {}}, TrainConfig())
    assert load_checkpoint_params(str(tmp_path / "p")).keys() == params.keys()


def _image(c, hdr=False, snorm=False):
    g = np.random.default_rng(c)
    img = g.random((40, 56, c), np.float32)
    if hdr:
        img[..., :3] *= 20.0
    if snorm or c >= 9:
        img[..., -3:] = img[..., -3:] * 2 - 1
    img[0, 0, 0] = np.nan
    return img


@pytest.mark.parametrize("c, kw", [(6, dict(transfer="srgb")), (3, dict(transfer="srgb")),
                                   (9, dict(transfer="pu", hdr=True)), (3, dict(snorm=True))],
                         ids=["srgb_alb", "srgb", "hdr_pu_alb_nrm", "snorm"])
def test_infer_matches_jax(c, kw):
    params = jax.device_get(init_unet_params(c, seed=c))
    img = _image(c, hdr=kw.get("hdr", False), snorm=kw.get("snorm", False))
    want = JaxInfer(params, **kw)(img)
    got = Infer(params, device="cpu", **kw)(img)
    assert got.shape == (40, 56, 3)
    np.testing.assert_allclose(got, want, atol=INFER_ATOL,
                               rtol=INFER_HDR_RTOL if kw.get("hdr") else 1e-7)


def test_infer_aux_chain_matches_jax():
    main, alb, nrm = (jax.device_get(init_unet_params(c, seed=s)) for c, s in ((9, 0), (3, 1), (3, 2)))
    img = _image(9)
    want = JaxInfer(main, aux_infers={"albedo": JaxInfer(alb), "normal": JaxInfer(nrm, snorm=True)})(img)
    got = Infer(main, device="cpu", aux_infers={"albedo": Infer(alb, device="cpu"),
                                                "normal": Infer(nrm, snorm=True, device="cpu")})(img)
    np.testing.assert_allclose(got, want, atol=INFER_ATOL)
    plain = Infer(main, device="cpu")(img)
    assert np.abs(plain - got).max() > 0  # the prefilters changed the aux input


def test_metrics_match_jax():
    g = np.random.default_rng(3)
    a, b = g.random((48, 40, 3), np.float32), g.random((48, 40, 3), np.float32)
    assert list(METRICS) == list(JAX_METRICS)
    for name in ("mse", "rmse", "psnr"):
        assert METRICS[name](a, b) == pytest.approx(JAX_METRICS[name](a, b), rel=1e-6)
    assert METRICS["ssim"](a, b, device="cpu") == pytest.approx(JAX_METRICS["ssim"](a, b), abs=1e-6)
    assert METRICS["psnr"](a, a) == float("inf")


def test_find_lr_matches_jax(tmp_path, monkeypatch):
    g = np.random.default_rng(0)
    for i in range(2):
        np.save(tmp_path / f"s{i}.input.npy", g.random((40, 40, 6), np.float32))
        np.save(tmp_path / f"s{i}.target.npy", g.random((40, 40, 3), np.float32))
    params = jax.device_get(init_unet_params(6, seed=9))
    monkeypatch.setattr(jax_find_lr, "init_unet_params", lambda c, seed: params)
    monkeypatch.setattr(port_find_lr, "init_params", lambda c, seed: params)
    kw = dict(num_steps=6, batch_size=2, tile_size=32, min_lr=1e-5, max_lr=1.0, seed=1)
    want_lrs, want_losses = jax_find_lr.find_lr(str(tmp_path), **kw)
    got_lrs, got_losses = port_find_lr.find_lr(str(tmp_path), device="cpu", **kw)
    np.testing.assert_array_equal(got_lrs, want_lrs)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LR_LOSS_RTOL)
