"""Training losses on NHWC tensors; each returns a 0-d tensor.

The port's counterpart of ``mygpuraytracer_tpu/train/losses.py``
(training/loss.py): L1, L2, MAPE, SMAPE, SSIM, MS-SSIM, the default mix
0.16 L1 + 0.84 (1 - MS-SSIM) [Zhao et al., "Loss functions for image
restoration with neural networks"], and L1 + forward-difference gradient.

Every loss is a function of batch means, written once in two halves: the
(sum, element count) pairs behind the means (:func:`loss_sums`) and the
loss formed from the means (:func:`loss_from_means`). One device divides
its own sums. A batch split over devices (``train.mesh_loss``) adds its
shards' pairs before dividing, so it gets the loss of the whole batch, not
a mean of its shards' losses, which differs wherever the loss is not
linear in its means (MS-SSIM's product form, or shards of unequal sizes).
"""

from __future__ import annotations

import torch

from .ssim import ms_ssim_from_means, ms_ssim_sums, ssim_sum

EPS = 1e-2  # MAPE's and SMAPE's
L1_MSSSIM_ALPHA = 0.16  # loss.py:28-29
L1_GRAD_ALPHA = 0.5


def _abs(x):
    """|x| with jnp.abs's gradient: +1 at 0 (torch.abs's is 0 there). A
    prediction equal to its target (a black crop through zero biases) is
    common early in training."""
    return torch.where(x >= 0, x, -x)


def _total(x):
    return torch.sum(x), x.numel()


def _grad(x):
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    return dx, dy


def _l1_sums(pred, target):
    return [_total(_abs(pred - target))]


def _l1_grad_sums(pred, target):
    """L1 and the L1 of the forward differences along W and H."""
    pdx, pdy = _grad(pred)
    tdx, tdy = _grad(target)
    return _l1_sums(pred, target) + [_total(_abs(pdx - tdx)), _total(_abs(pdy - tdy))]


def _first(means, h, w):
    return means[0]


def _msssim(means, h, w):
    # The sum form: bounded gradients; the product form is the metric's.
    return 1.0 - ms_ssim_from_means(means, h, w, product=False)


def _l1_msssim(means, h, w):
    return L1_MSSSIM_ALPHA * means[0] + (1.0 - L1_MSSSIM_ALPHA) * _msssim(means[1:], h, w)


def _l1_grad(means, h, w):
    return L1_GRAD_ALPHA * means[0] + (1 - L1_GRAD_ALPHA) * (0.5 * (means[1] + means[2]))


# name: (the sums of a batch or a shard, the loss from the whole batch's
# means and the images' H, W)
_TERMS = {
    "l1": (_l1_sums, _first),
    "l2": (lambda p, t: [_total((p - t) ** 2)], _first),
    # mean absolute percentage error (relative L1), and its symmetric form
    "mape": (lambda p, t: [_total(_abs(p - t) / (_abs(t) + EPS))], _first),
    "smape": (lambda p, t: [_total(2.0 * _abs(p - t) / (_abs(p) + _abs(t) + EPS))], _first),
    "ssim": (lambda p, t: [ssim_sum(p, t)], lambda means, h, w: 1.0 - means[0]),
    "msssim": (ms_ssim_sums, _msssim),
    "l1_msssim": (lambda p, t: _l1_sums(p, t) + ms_ssim_sums(p, t), _l1_msssim),
    "l1_grad": (_l1_grad_sums, _l1_grad),
}


def loss_sums(name: str, pred, target) -> list[tuple[torch.Tensor, int]]:
    """The (sum, element count) pairs behind the loss ``name`` on a batch or
    a shard of one."""
    if name not in _TERMS:
        raise ValueError(f"invalid loss function '{name}'")
    return _TERMS[name][0](pred, target)


def loss_from_means(name: str, means, h: int, w: int):
    """The loss ``name`` from the whole batch's means of :func:`loss_sums`
    (H, W: the images' size, which sets MS-SSIM's scales)."""
    return _TERMS[name][1](means, h, w)


def _batch_loss(name: str):
    def loss(pred, target):
        sums = loss_sums(name, pred, target)
        return loss_from_means(name, [total / count for total, count in sums],
                               int(pred.shape[1]), int(pred.shape[2]))

    loss.__name__ = f"{name}_loss"
    return loss


_LOSSES = {name: _batch_loss(name) for name in _TERMS}
(l1_loss, l2_loss, mape_loss, smape_loss, ssim_loss, msssim_loss, l1_msssim_loss,
 l1_grad_loss) = _LOSSES.values()


def get_loss_function(name: str = "l1_msssim"):
    """training/loss.py:13-33: the loss of that name, else ValueError."""
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"invalid loss function '{name}'") from None
