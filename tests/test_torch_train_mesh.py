"""The trainer's mesh (``train/train.py``: ``make_mesh``, ``build_train_step``
and ``build_eval_step`` with a mesh, ``train(cfg, mesh)``) against the JAX
trainer's ``dp`` mesh on its 8 virtual CPU devices, and against the port's
own single device.

A port mesh is one process driving a tuple of devices (``("cpu",) * 2``
and ``* 4`` here); the batch splits evenly over it, each shard runs on a
replica of the master weights, and the loss is formed from the whole
batch's means. JAX's sharded step computes the loss of the whole batch.

Tolerances, those of ``test_torch_train_step.py``: float32 loss rtol 1e-5
against JAX's sharded loss and the port's single device; gradients within
1e-5 x the largest |gradient| of the port's single-device gradients of the
whole batch, and for ``l1`` of JAX's sharded ones (at this batch of 8 the
port's and JAX's float32 ``l1_msssim`` gradients each lie 3.4e-4 x from
float64, whose ReLU and max-pool decisions flip at near-ties, and within
2e-5 x of each other, tests/test_torch_train_grad_parity.py: the mesh is
held to the function the port computes on one device); parameters after two steps within 2 x the sum of
the learning rates of JAX's (Adam turns a near-zero gradient into +-lr);
per-example validation losses rtol 1e-5.

The non-additive case. MS-SSIM takes one batch mean per scale and then a
power and a product (the metric's product form): a mean of the shards'
values is another function. The mesh forms the whole batch's per-scale
means from the shards' sums (``ssim.ms_ssim_sums``) before the product.
The trainer's default loss, 0.16 L1 + 0.84 (1 - MS-SSIM), takes the
weighted-sum form, which is linear in those means: over equal shards the
mean of the shard losses equals it up to float rounding (1.4e-7 relative
on this test's batch), so the product form is the one that tells the two
apart (1e-3 relative here, 100 x the loss tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from mygpuraytracer_tpu.denoise.unet import init_unet_params, unet_apply as jax_unet_apply
from mygpuraytracer_tpu.train.losses import get_loss_function as jax_loss
from mygpuraytracer_tpu.train.train import TrainConfig as JaxTrainConfig
from mygpuraytracer_tpu.train.train import build_eval_step as jax_build_eval_step
from mygpuraytracer_tpu.train.train import build_train_step as jax_build_train_step
from mygpuraytracer_tpu.train.train import make_mesh as jax_make_mesh
from mygpuraytracer_tpu.train.train import make_preprocess as jax_make_preprocess

from mygpuraytracer_tpu_torch.denoise.unet import jax_tree, params_from_jax, params_to_jax
from mygpuraytracer_tpu_torch.train.losses import get_loss_function, loss_from_means, loss_sums
from mygpuraytracer_tpu_torch.train.ssim import ms_ssim, ms_ssim_from_means, ms_ssim_sums
from mygpuraytracer_tpu_torch.train.train import (Optimizer, TrainConfig, build_eval_step,
                                                  build_train_step, exact_float32, make_mesh,
                                                  make_preprocess, mesh_loss, onecycle_schedule,
                                                  unet_train_apply)
from test_torch_train_step import GRAD_REL, LOSS_RTOL, batch

BATCH = 8
STEPS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8)


def cpu_mesh(size):
    return make_mesh(devices=("cpu",) * size)


def _jax_sharded_grads(cfg, params, x, y, mesh):
    """JAX's loss and gradients of the batch sharded over ``mesh`` (the
    value_and_grad inside its mesh train step)."""
    loss_fn = jax_loss(cfg.loss)
    pre = jax_make_preprocess(cfg)

    def value(p, xx, yy):
        xx, yy = pre(xx, yy)
        return loss_fn(jax_unet_apply(p, xx).astype(jnp.float32), yy)

    batch_sharding, replicated = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    fn = jax.jit(jax.value_and_grad(value),
                 in_shardings=(replicated, batch_sharding, batch_sharding))
    loss, grads = fn(params, jnp.asarray(x), jnp.asarray(y))
    return float(loss), jax.device_get(grads)


@pytest.fixture(scope="module")
def jax_grads(jax_mesh):
    """(batch, params, JAX's sharded ``l1`` loss and gradients)."""
    x, y = batch(21, n=BATCH)
    params = init_unet_params(6, seed=7)
    cfg = JaxTrainConfig(in_channels=6, loss="l1", precision="float32")
    return x, y, params, _jax_sharded_grads(cfg, params, x, y, jax_mesh)


def _grads(cfg, params, x, y, mesh=None):
    """The port's loss and gradients of the batch, on ``mesh`` or one device."""
    net = params_from_jax(jax.device_get(params))
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    with exact_float32():
        if mesh is None:
            xx, yy = make_preprocess(cfg)(x, y)
            loss = get_loss_function(cfg.loss)(unet_train_apply(net, xx, torch.float32), yy)
        else:
            loss = mesh_loss(cfg, net, mesh, x, y, make_preprocess(cfg), torch.float32)
        loss.backward()
    return float(loss.detach()), jax_tree(net, lambda p: p.grad)


def _assert_grads_close(got, refs):
    for ref in refs:
        scale = max(float(np.abs(g).max()) for p in ref.values() for g in p.values())
        for name in ref:
            for k in ("w", "b"):
                np.testing.assert_allclose(got[name][k], ref[name][k], atol=GRAD_REL * scale,
                                           rtol=0)


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_loss_and_grads_match_jax(size, jax_grads):
    """``l1``: the loss against JAX's sharded loss and the port's single
    device (rtol 1e-5), the gradients within 1e-5 x the largest of both."""
    x, y, params, (want_loss, want_grads) = jax_grads
    cfg = TrainConfig(in_channels=6, loss="l1", precision="float32")
    got_loss, got_grads = _grads(cfg, params, x, y, cpu_mesh(size))
    single_loss, single = _grads(cfg, params, x, y)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert got_loss == pytest.approx(single_loss, rel=LOSS_RTOL)
    _assert_grads_close(got_grads, [want_grads, single])


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_msssim_grads_match_single_device(size):
    """``l1_msssim`` (the default): the loss and the gradients against the
    port's single device (rtol 1e-5; 1e-5 x the largest gradient). JAX's
    are held to the port's single device by
    tests/test_torch_train_grad_parity.py (float64 is no yardstick at this
    batch: both float32 sides lie 3.4e-4 x from it); the loss is held to
    JAX's by test_mesh_steps_match_jax_8_device_steps."""
    x, y = batch(21, n=BATCH)
    params = init_unet_params(6, seed=7)
    cfg = TrainConfig(in_channels=6, precision="float32")
    got_loss, got_grads = _grads(cfg, params, x, y, cpu_mesh(size))
    single_loss, single = _grads(cfg, params, x, y)
    assert got_loss == pytest.approx(single_loss, rel=LOSS_RTOL)
    _assert_grads_close(got_grads, [single])


@pytest.fixture(scope="module")
def jax_steps(jax_mesh):
    """Two float32 steps of JAX's ``build_train_step(cfg, opt,
    make_mesh(8))``: the batches, the initial params, the losses and the
    params after them."""
    xs = [batch(30 + s, n=BATCH) for s in range(STEPS)]
    params = init_unet_params(6, seed=8)
    jcfg = JaxTrainConfig(in_channels=6, precision="float32", num_epochs=1,
                          steps_per_epoch=STEPS)
    schedule = optax.cosine_onecycle_schedule(transition_steps=max(STEPS, 16),
                                              peak_value=jcfg.max_lr, pct_start=jcfg.warmup_pct)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))
    step, sharding = jax_build_train_step(jcfg, opt, jax_mesh)
    jp, state, losses = params, opt.init(params), []
    for x, y in xs:
        jp, state, loss = step(jp, state, jax.device_put(jnp.asarray(x), sharding),
                               jax.device_put(jnp.asarray(y), sharding))
        losses.append(float(loss))
    return xs, params, losses, jax.device_get(jp)


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_steps_match_jax_8_device_steps(size, jax_steps):
    """Two float32 steps of ``build_train_step(cfg, optimizer, mesh)``
    against JAX's ``build_train_step(cfg, opt, make_mesh(8))``: the losses
    (rtol 1e-5) and the params after them (within 2 x the sum of the
    learning rates)."""
    xs, params, want, jp = jax_steps
    cfg = TrainConfig(in_channels=6, precision="float32", num_epochs=1, steps_per_epoch=STEPS)
    mesh = cpu_mesh(size)
    net = params_from_jax(jax.device_get(params))
    optimizer = Optimizer(net, onecycle_schedule(STEPS, cfg.max_lr, cfg.warmup_pct))
    step_fn, split = build_train_step(cfg, optimizer, mesh)
    assert split is mesh
    got = [float(step_fn(torch.from_numpy(x), torch.from_numpy(y))) for x, y in xs]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    bound = 2 * sum(optimizer.schedule(s) for s in range(STEPS))
    tp = params_to_jax(net)
    for name in jp:
        for k in ("w", "b"):
            np.testing.assert_allclose(tp[name][k], jp[name][k], atol=bound, rtol=0)


def test_mesh_eval_step_matches_jax(jax_mesh):
    x, y = batch(40, n=BATCH)
    params = init_unet_params(6, seed=9)
    kw = dict(in_channels=6, precision="float32")
    want = np.asarray(jax_build_eval_step(JaxTrainConfig(**kw), jax_mesh)(
        params, jnp.asarray(x), jnp.asarray(y)))
    got = build_eval_step(TrainConfig(**kw), cpu_mesh(4))(
        params_from_jax(jax.device_get(params)), torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)


def _split_msssim_batch():
    """Half the batch near its target, half far from it: the shards'
    MS-SSIM differ widely."""
    g = np.random.default_rng(0)
    a = torch.from_numpy(g.random((BATCH, 32, 32, 3), np.float32))
    b = a.clone()
    b[:BATCH // 2] = torch.from_numpy(g.random((BATCH // 2, 32, 32, 3), np.float32))
    b[BATCH // 2:] += 0.01 * torch.from_numpy(g.standard_normal((BATCH // 2, 32, 32, 3))
                                              .astype(np.float32))
    return a, b


def test_ms_ssim_of_shards_is_the_whole_batchs():
    """The non-additive MS-SSIM (product form): the mean of the shards'
    values misses the whole batch's by more than 10 x the loss tolerance,
    and the shards' sums put together (ms_ssim_sums, ms_ssim_from_means,
    the mesh's route) give the whole batch's within it."""
    a, b = _split_msssim_batch()
    whole = float(ms_ssim(a, b))
    halves = [(a[i:i + BATCH // 2], b[i:i + BATCH // 2]) for i in (0, BATCH // 2)]
    shard_mean = float(np.mean([float(ms_ssim(x, y)) for x, y in halves]))
    assert abs(shard_mean - whole) > 10 * LOSS_RTOL * abs(whole)
    sums = [ms_ssim_sums(x, y) for x, y in halves]
    means = [(s0 + s1) / (c0 + c1) for (s0, c0), (s1, c1) in zip(*sums)]
    assert float(ms_ssim_from_means(means, 32, 32)) == pytest.approx(whole, rel=LOSS_RTOL)
    assert float(ms_ssim_from_means(means, 32, 32, product=False)) == pytest.approx(
        float(ms_ssim(a, b, product=False)), rel=LOSS_RTOL)


@pytest.mark.parametrize("name", ["l1", "l2", "mape", "smape", "ssim", "msssim", "l1_msssim",
                                  "l1_grad"])
def test_loss_from_shard_sums_is_the_whole_batch_loss(name):
    """Every loss of the registry from two shards' sums equals the loss of
    the whole batch (rtol 1e-5)."""
    a, b = _split_msssim_batch()
    want = float(get_loss_function(name)(a, b))
    sums = [loss_sums(name, a[i:i + BATCH // 2], b[i:i + BATCH // 2]) for i in (0, BATCH // 2)]
    means = [(s0 + s1) / (c0 + c1) for (s0, c0), (s1, c1) in zip(*sums)]
    assert float(loss_from_means(name, means, 32, 32)) == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_loss_equals_the_single_device_loss(size):
    """The trainer's mesh loss on the split batch equals the single-device
    loss of the whole batch (rtol 1e-5)."""
    a, b = _split_msssim_batch()
    x = torch.cat([a, torch.rand(a.shape, generator=torch.Generator().manual_seed(1))], dim=-1)
    cfg = TrainConfig(in_channels=6, precision="float32")
    net = params_from_jax(jax.device_get(init_unet_params(6, seed=12)))
    pre = make_preprocess(cfg)
    with torch.no_grad(), exact_float32():
        got = float(mesh_loss(cfg, net, cpu_mesh(size), x, b, pre, torch.float32))
        xx, yy = pre(x, b)
        want = float(get_loss_function(cfg.loss)(unet_train_apply(net, xx, torch.float32), yy))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_uneven_batch_raises():
    x, y = batch(50, n=6)
    cfg = TrainConfig(in_channels=6, precision="float32")
    net = params_from_jax(jax.device_get(init_unet_params(6, seed=1)))
    step_fn, _ = build_train_step(cfg, Optimizer(net, onecycle_schedule(1, 1e-4)), cpu_mesh(4))
    with pytest.raises(ValueError, match="divide"):
        step_fn(torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(ValueError, match="divide"):
        build_eval_step(cfg, cpu_mesh(4))(net, torch.from_numpy(x), torch.from_numpy(y))
