"""The port's counterpart of ``jax.jit`` for a step: one captured CUDA
graph a static key (JAX compiles ``make_decode_fns``' step,
``make_greedy_step`` and the engine's ``_make_step`` / ``_make_chain_step``
with ``t_eff`` (and ``want_lps``) static: one executable a length bucket;
the speculative rounds with ``t_eff`` / ``d_eff`` static; the engine's
admission prefill a (bucket, total, cached, draft) and its grouped
admission a (bucket, padded group)).

A ``CapturedStep`` wraps ``fn(*inputs, **key)``, which returns a tensor or a
tuple of tensors: the inputs are tensors of fixed shape, the keywords are
static, hashable values. On a CUDA tensor the first call of each key
captures ``fn`` into a ``torch.cuda.CUDAGraph``, and every call replays it:

  * the inputs are written with ``copy_`` into static buffers that the
    object holds (never rebound), and the outputs are the graph's own
    static buffers: the next call of the same key overwrites them, so a
    caller clones what must outlive it;
  * whatever else ``fn`` reads (the parameters, the KV cache) is read at the
    addresses it had at capture; the caller keys its CapturedSteps by those
    buffers (``sampling``: by the parameter tree and the cache; the engine
    owns both). ``fn`` writes what it updates in place (the cache's
    ``length`` with ``copy_``) and makes no host sync;
  * before a capture ``fn`` runs once on the capture stream, a stream kept
    for the device: libraries load, and the per-stream buffers of
    ``kernels/_sync.py`` and attn_decode's counters are made and zeroed
    there, outside the graph (made inside it, they would be zeroed at
    every replay). The ``state`` tensors that ``fn`` updates are put back
    after this warm-up, so the first call, too, is a replay. The graphs of
    one CapturedStep share one memory pool;
  * the generators (``torch.Generator``) that ``fn`` draws from are
    registered with each graph (a replay then draws anew and advances the
    generator, as an eager call does), and their states are put back after
    the warm-up, so that the first replay draws what an eager first call
    would draw;
  * Python's cyclic garbage collector is off during a capture: a dead
    graph (an engine dropped in a reference cycle, with its CapturedSteps)
    destroyed by a collection inside a capture would invalidate it (CUDA
    refuses to destroy a graph while a stream captures);
  * a capture that fails raises RuntimeError naming the first CUDA error;
    nothing runs eagerly in its place.

On a CPU tensor the same object runs ``fn`` eagerly through the same static
buffers: the plain version, which the tests hold against the JAX package.
Inside ``disabled()`` (the counterpart of ``jax.disable_jit()``) every
CapturedStep calls ``fn`` on its arguments directly: the eager form on the
card.

Launches: ``kernels/_build.py`` counts a launch in Python, so a replay by
itself counts nothing. The warm-up and the capture count nothing, and each
replay adds what the capture counted, so the counters read as after an
eager run. ``COUNTS`` holds the captures, replays and seconds spent
capturing (warm-up included) since ``reset_counts()``.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from ..kernels import _build

COUNTS = {"captures": 0, "replays": 0, "capture_s": 0.0}
_DISABLED = [0]  # the depth of open disabled() contexts
_STREAMS: dict = {}  # device -> its capture stream


def reset_counts():
    COUNTS.update(captures=0, replays=0, capture_s=0.0)


@contextlib.contextmanager
def disabled():
    """Every CapturedStep calls its function eagerly inside (process-wide,
    as ``jax.disable_jit()``)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def is_disabled() -> bool:
    return _DISABLED[0] > 0


def capture_stream(device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` warms up and captures on, made
    once: the per-stream buffers the graphs' kernels use are this stream's."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


class _Graph:
    """One key's static buffers, its graph and the launches it counts."""

    def __init__(self, inputs):
        self.inputs = tuple(torch.empty_like(x) for x in inputs)
        self.outputs = None  # a tuple of tensors once fn has run
        self.single = False  # fn returned one tensor, not a tuple
        self.graph = None
        self.launches = None  # _build.launch_delta of one replay


class CapturedStep:
    def __init__(self, fn, state=(), generators=()):
        """fn(*inputs, **key) -> tensor or tuple of tensors, capturable (no
        host sync). state: the tensors fn updates in place, restored after
        the warm-up before a capture. generators: the torch.Generators fn
        draws from, registered with every graph."""
        self.fn = fn
        self.state = tuple(state)
        self.generators = tuple(generators)
        self._graphs: dict = {}
        self._pool = None

    def __call__(self, *inputs, **key):
        if _DISABLED[0]:
            return self.fn(*inputs, **key)
        k = tuple(sorted(key.items()))
        g = self._graphs.get(k)
        if g is None:
            g = self._graphs[k] = _Graph(inputs)
        for static, x in zip(g.inputs, inputs):
            if x is not static:
                static.copy_(x, non_blocking=True)
        if g.inputs[0].is_cuda:
            if g.graph is None:
                self._capture(g, key)
            self._replay(g)
        else:
            self._run_eagerly(g, key)
        return g.outputs[0] if g.single else g.outputs

    def _run_eagerly(self, g, key):
        outs = self.fn(*g.inputs, **key)
        g.single = not isinstance(outs, tuple)
        outs = (outs,) if g.single else outs
        if g.outputs is None:
            g.outputs = outs
        else:
            for static, o in zip(g.outputs, outs):
                static.copy_(o)

    def _capture(self, g, key):
        t0 = time.perf_counter()
        dev = g.inputs[0].device
        stream = capture_stream(dev)
        counts = _build.launch_counts()
        saved = [t.clone() for t in self.state]
        rng_saved = [gen.get_state() for gen in self.generators]
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.fn(*g.inputs, **key)  # the warm-up
                for t, s in zip(self.state, saved):
                    t.copy_(s)
            for gen, s in zip(self.generators, rng_saved):
                gen.set_state(s)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                if not hasattr(graph, "register_generator_state"):
                    raise RuntimeError(
                        "CapturedStep: this torch cannot register a "
                        "generator with a CUDA graph "
                        "(CUDAGraph.register_generator_state)")
                graph.register_generator_state(gen)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                    before = _build.launch_counts()
                    outs = self.fn(*g.inputs, **key)
                    after = _build.launch_counts()
            except RuntimeError as e:
                cause = e  # the first error of the capture, not capture_end's
                while isinstance(cause.__context__, RuntimeError):
                    cause = cause.__context__
                raise RuntimeError(
                    "CapturedStep: the step could not be captured into a CUDA "
                    "graph (it must make no host sync: .item(), int() or "
                    ".cpu() of a tensor, boolean-mask indexing; and use only "
                    f"capturable ops). Cause: {str(cause).splitlines()[0]}"
                ) from e
            finally:
                if collecting:
                    gc.enable()
        finally:
            _build.set_launch_counts(counts)
        torch.cuda.current_stream(dev).wait_stream(stream)
        g.single = not isinstance(outs, tuple)
        g.outputs = (outs,) if g.single else outs
        g.launches = _build.launch_delta(before, after)
        g.graph = graph
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += time.perf_counter() - t0

    def _replay(self, g):
        g.graph.replay()
        _build.add_launches(g.launches)
        COUNTS["replays"] += 1


class PerObjects:
    """One value (a CapturedStep, or a step run eagerly) made by
    ``make(*objects)`` for the objects it was last asked for: the parameter
    trees, caches and generator that a step's graphs read at the addresses
    they had at capture. It is held with them, so that no identity is
    reused while its graphs live, and with the addresses of their buffers;
    other objects, or moved buffers, make a new one."""

    def __init__(self, make):
        self.make = make
        self._held = None  # (objects, addresses, value)

    def __call__(self, objects: tuple, addresses: tuple):
        held = self._held
        if held is None or held[1] != addresses or any(
                a is not b for a, b in zip(held[0], objects)):
            self._held = held = (objects, addresses, self.make(*objects))
        return held[2]
