"""The Renderer's compiled step: whole iterations as CUDA graphs.

Counterpart of the JAX Renderer's jitted ``_iteration_step`` and
``_multi_step`` (``mygpuraytracer_tpu/render/renderer.py``), which run an
iteration, or a ``fori_loop`` of them, as one device program with donated
accumulators. Here an iteration is recorded once into a
``torch.cuda.CUDAGraph`` and replayed, so a replay costs the host one graph
launch instead of one launch per PyTorch op and per kernel.

A graph records pointers and the values of every launch's arguments, so
what it reads must stay where it was and change only on the device:

- the iteration is a 0-dim int64 counter on the device; the graph reads it,
  derives the iteration key and the uniforms from it (K6 and K5 read it
  from device memory and derive their words themselves), and adds to it in
  place;
- it accumulates in place into the Renderer's persistent ``acc``,
  ``dir_acc`` and first-bounce cache, and reads the scene's tensors, the
  camera's (which ``Renderer.move_camera`` overwrites in place) and K5's
  scene record;
- no value goes back to the host: the bounce loop has no host guard
  (render/pathtrace.py);
- iteration 1 writes the AOVs and fills the cache, work the later
  iterations must not pay, so on the wavefront route it is a graph of its
  own, and "first" is fixed when it is captured, not read from the
  counter.

Three steps are captured, one iteration each: :func:`wavefront_first_step`
(the wavefront's iteration 1, replayed after every ``reset`` or
``move_camera``), :func:`wavefront_step` (a later wavefront iteration) and
:func:`bounce_step` (a later K5-route iteration: K6's raygen uniforms, the
camera rays and one K5 launch). A Renderer's first iteration 1 runs
eagerly, as the captures' warm-up (the kernel libraries load, the
allocator's workspaces and the wrappers' device counts exist), and the
wavefront's first-iteration graph is captured right after it; the K5
route's iteration 1 stays eager (a few launches). Which route a Renderer
takes is decided up front from its options (``Renderer.graph_route``); a
capture or replay error raises, and nothing falls back to the eager path.
:func:`disabled` runs the eager path on purpose, as ``jax.disable_jit()``
does.

A capture runs the wrappers once, so their host counters (``LAUNCHES``)
count it as one launch and no replay; each wrapper also adds one, on the
device, to its count kept there (``_build.count_on_device``), and the graph
records that add with the launch, so the device counts hold every replay's
launches.
"""

from __future__ import annotations

import contextlib
import time

import torch

from . import megakernel
from .pathtrace import accumulate_sample, render_sample, store_cache

_disabled = 0


@contextlib.contextmanager
def disabled():
    """Run the Renderer's steps eagerly inside the block, launch by launch,
    as ``jax.disable_jit()`` runs jitted functions op by op."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def enabled() -> bool:
    """Whether the Renderer may replay graphs (no :func:`disabled` block)."""
    return _disabled == 0


class Captured:
    """``body()`` recorded once into a CUDA graph in the memory pool
    ``pool`` and replayed on the current stream. ``seconds``: the host time
    of the capture."""

    def __init__(self, body, pool):
        t = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread (the preview server's) may use the card meanwhile.
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            body()
        self.seconds = time.perf_counter() - t

    def replay(self) -> None:
        self.graph.replay()


def wavefront_first_step(dev, meta, options, base_key, counter: torch.Tensor,
                         acc: torch.Tensor, dir_acc: torch.Tensor, cache) -> None:
    """The capture route's wavefront iteration 1: iteration ``counter`` (a
    0-dim int64 tensor, set to 1) through ``render_sample`` as the first,
    its color added into ``acc`` (zeroed by ``reset``) and ``dir_acc``,
    its AOVs written into ``acc[3:9]`` and bounce 0's hit into the
    first-bounce cache ``cache`` (or None), all in place; then
    ``counter += 1`` in place. On the CPU it runs eagerly and computes what
    ``render_sample`` and ``accumulate_sample`` compute at the int 1."""
    out = render_sample(dev, meta, options, counter, base_key, cache, first=True)
    accumulate_sample(acc, out, counter, dir_acc, first=True)
    store_cache(cache, out)
    counter += 1


def wavefront_step(dev, meta, options, base_key, counter: torch.Tensor, acc: torch.Tensor,
                   dir_acc: torch.Tensor, cache) -> None:
    """The capture route's wavefront iteration: iteration ``counter`` (a
    0-dim int64 tensor, at least 2) through ``render_sample``, added into
    ``acc`` and ``dir_acc`` in place, reading the first-bounce cache
    ``cache`` (or None); then ``counter += 1`` in place. On the CPU it runs
    eagerly and computes what ``render_sample`` and ``accumulate_sample``
    compute for that iteration's int."""
    out = render_sample(dev, meta, options, counter, base_key, cache)
    accumulate_sample(acc, out, counter, dir_acc)
    counter += 1


def bounce_step(dev, meta, options, base_key, counter: torch.Tensor, acc: torch.Tensor,
                record: torch.Tensor) -> None:
    """The capture route's K5 iteration: iteration ``counter`` (a 0-dim
    int64 tensor, at least 2) through ``bvh_bounce_accumulate`` into ``acc``
    in place; then ``counter += 1`` in place."""
    megakernel.bvh_bounce_accumulate(dev, meta, options, acc, counter, 1, base_key,
                                     record=record)
    counter += 1
