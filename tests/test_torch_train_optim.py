"""The port's optimizer against optax: the one-cycle schedule, the global
norm clip and ``chain(clip_by_global_norm(1.0), adam(schedule))``.

Tolerances: the schedule rtol 1e-6 at every step (optax evaluates it with
the phase position in float64 and the cosine in float32; the port does the
same, with a correctly rounded cosine); the clip rtol 1e-6; ten updates of
the chain: each param within 1e-5 of the sum of the learning rates applied
(an Adam update is about +-lr, so rtol 1e-5 on each update), plus one
float32 ulp of the param per update (an update of ~1e-5 added to a param
of ~0.1 rounds to the param's ulp, so an update that differs in its last
bits may move each sum by one ulp); Adam's moments rtol 1e-5 of the
layer's largest (a first moment that sums grads of both signs cancels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mygpuraytracer_tpu.denoise.unet import init_unet_params

from mygpuraytracer_tpu_torch.denoise.unet import conv_specs, params_from_jax, params_to_jax
from mygpuraytracer_tpu_torch.train.train import Ema, Optimizer, onecycle_schedule

SCHEDULE_RTOL = 1e-6
CLIP_RTOL = 1e-6
ADAM_RTOL = 1e-5
ADAM_ULPS_PER_UPDATE = 1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("total", [1, 5, 16, 64, 2000 * 32])
def test_schedule_matches_optax(total):
    ref = optax.cosine_onecycle_schedule(max(total, 16), 2e-4, pct_start=0.15)
    ours = onecycle_schedule(total, 2e-4, 0.15)
    transition = max(total, 16)
    if transition <= 1000:
        steps = range(transition + 4)
    else:  # sampled: every 97th step, both phase ends and the tail
        steps = sorted({*range(0, transition + 4, 97), *range(0, 8), *range(9590, 9610),
                        *range(transition - 40, transition + 4)})
    got = np.array([ours(s) for s in steps])
    want = np.array([float(ref(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL)
    assert ours(0) == pytest.approx(2e-4 / 25, rel=1e-5)


def test_schedule_is_not_onecyclelr():
    """The phase end sits at int(0.15 * total) (OneCycleLR's one step earlier)."""
    s = onecycle_schedule(100, 2e-4, 0.15)
    assert s(15) == pytest.approx(2e-4, rel=1e-6) and s(14) < s(15) and s(16) < s(15)


SHAPES = {name: {"w": (3, 3, cin, cout), "b": (cout,)} for name, cin, cout in conv_specs(3)}


def _grads_tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: {w: (scale * rng.standard_normal(shape)).astype(np.float32)
                for w, shape in p.items()} for k, p in SHAPES.items()}


def _set_grads(net, tree):
    back = params_from_jax(tree)
    for p, g in zip(net.parameters(), back.parameters()):
        p.grad = g.detach().clone()


@pytest.mark.parametrize("target", [0.5, 1.0, 3.0])
def test_clip_matches_optax(target):
    """Below, at and above the norm of 1.0."""
    tree = _grads_tree(1, 1.0)
    flat = np.concatenate([a.ravel() for p in tree.values() for a in p.values()])
    scale = np.float32(target) / np.float32(np.sqrt(np.sum(flat.astype(np.float64) ** 2)))
    tree = {k: {w: (a * scale).astype(np.float32) for w, a in p.items()} for k, p in tree.items()}
    if target == 1.0:  # exactly at the norm: one element 1, the rest 0
        tree = {k: {w: np.zeros_like(a) for w, a in p.items()} for k, p in tree.items()}
        tree["enc_conv0"]["b"][0] = 1.0
    want, _ = jax.jit(optax.clip_by_global_norm(1.0).update)(tree, None)
    net = params_from_jax(_grads_tree(0, 0.1))
    _set_grads(net, tree)
    opt = Optimizer(net, lambda count: 0.0)  # lr 0: the step leaves the params
    opt.step()
    got = {k: {"w": np.transpose(c.weight.grad.numpy(), (2, 3, 1, 0)), "b": c.bias.grad.numpy()}
           for k, c in net.convs.items()}
    for k in want:
        for w in ("w", "b"):
            np.testing.assert_allclose(got[k][w], np.asarray(want[k][w]), rtol=CLIP_RTOL,
                                       atol=1e-12)


def test_ten_updates_match_optax():
    params = jax.device_get(init_unet_params(3, seed=4))
    total = 10
    optimizer = optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adam(optax.cosine_onecycle_schedule(16, 2e-4, pct_start=0.15)))
    state = optimizer.init(params)
    net = params_from_jax(params)
    opt = Optimizer(net, onecycle_schedule(total, 2e-4, 0.15))
    jparams = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def update(grads, state, jparams):
        updates, state = optimizer.update(grads, state, jparams)
        return optax.apply_updates(jparams, updates), state

    for t in range(total):
        grads = _grads_tree(100 + t, 0.3 if t % 3 else 0.01)  # some steps clipped
        jparams, state = update(grads, state, jparams)
        _set_grads(net, grads)
        opt.step()
    assert opt.count == total
    lr_sum = sum(opt.schedule(t) for t in range(total))
    got, want = params_to_jax(net), jax.device_get(jparams)
    for k in want:
        for w in ("w", "b"):
            ulp = np.spacing(np.maximum(np.abs(want[k][w]), np.abs(params[k][w])))
            err = np.abs(got[k][w] - want[k][w])
            assert np.all(err <= ADAM_RTOL * lr_sum + ADAM_ULPS_PER_UPDATE * total * ulp), (k, w)
    # Adam's moments, kept in the checkpoint, against optax's
    mu, nu = state[1][0].mu, state[1][0].nu
    saved = opt.state()
    for k in want:
        for w in ("w", "b"):
            for got_m, want_m in ((saved["mu"][k][w], np.asarray(mu[k][w])),
                                  (saved["nu"][k][w], np.asarray(nu[k][w]))):
                np.testing.assert_allclose(got_m, want_m, rtol=ADAM_RTOL,
                                           atol=ADAM_RTOL * np.abs(want_m).max())


def test_optimizer_state_roundtrip_continues_identically():
    params = jax.device_get(init_unet_params(3, seed=5))
    runs = []
    for interrupted in (False, True):
        net = params_from_jax(params)
        opt = Optimizer(net, onecycle_schedule(6, 2e-4, 0.15))
        for t in range(6):
            if interrupted and t == 3:
                saved, snapshot = opt.state(), params_to_jax(net)
                net = params_from_jax(snapshot)
                opt = Optimizer(net, onecycle_schedule(6, 2e-4, 0.15))
                opt.load_state(saved)
            _set_grads(net, _grads_tree(200 + t, 0.1))
            opt.step()
        runs.append(params_to_jax(net))
    for k in runs[0]:
        for w in ("w", "b"):
            np.testing.assert_array_equal(runs[0][k][w], runs[1][k][w])


def test_ema_matches_jax_formula():
    params = jax.device_get(init_unet_params(3, seed=6))
    net = params_from_jax(params)
    ema = Ema(net, 0.9)
    moved = _grads_tree(7, 1.0)
    with torch.no_grad():
        for p, q in zip(net.parameters(), params_from_jax(moved).parameters()):
            p.copy_(q)
    ema.update(net.parameters())
    d = jnp.float32(0.9)
    want = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), params, moved)
    got = params_to_jax(ema.net)
    for k in want:
        for w in ("w", "b"):
            np.testing.assert_allclose(got[k][w], np.asarray(want[k][w]), rtol=1e-6, atol=1e-7)
