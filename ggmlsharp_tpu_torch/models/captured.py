"""The port's counterpart of ``jax.jit`` for a step: one captured CUDA
graph a static key (JAX compiles ``make_decode_fns``' step,
``make_greedy_step`` and the engine's ``_make_step`` / ``_make_chain_step``
with ``t_eff`` (and ``want_lps``) static: one executable a length bucket;
the speculative rounds with ``t_eff`` / ``d_eff`` static; the engine's
admission prefill a (bucket, total, cached, draft) and its grouped
admission a (bucket, padded group); and the training and evaluation
forms: an ``opt_adam`` / ``opt_torch`` call's step, ``Graph.compute`` a
topology and input spec, a ``perplexity`` call's window).

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
    after this warm-up, so the first call, too, is a replay. With
    ``warm_first_call`` (an optimizer's step, whose state is its
    parameters and moments) the first call of a key is the warm-up itself,
    run eagerly on the capture stream, its result returned and its
    updates kept; the key is captured at its second call. The graphs of
    one CapturedStep share one memory pool (``GraphPool``; those of a
    graph cache entry one pool an entry); ``release()`` drops them;
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

The in-graph bucket switch (JAX's ``lax.switch`` for a ``t_eff=None``
call, one executable): ``step.switch(bounds, *inputs, **key)`` calls ``fn``
with each bound's keyword at the bucket that bound's lengths select on the
device (``kernels.graph_switch``). On the card its first call of a key
warms ``fn`` up once at the widest buckets and captures one body a bucket
combination (``keep_graph=True``, the CapturedStep's pool: one body runs a
launch), each writing its outputs into one set of output buffers; the
parent graph (a selector kernel and a conditional node over the bodies) is
launched at every call, with no host read. It counts as one capture
(``COUNTS["switch_bodies"]`` counts its bodies) and each launch as one
replay plus one ``graph_switch`` launch; the bodies must launch the same
kernels (they differ only in how many cache rows attention reads). A
sampled step's generators are registered with every body and with a small
prologue graph replayed before each launch, which writes the generators'
seed and offset where the bodies read them; the offset then advances by
what one call draws. ``SWITCH["design"]`` names the parent the build made
("switch" or "if_chain"). On the CPU ``fn`` runs at each bound's widest
bucket (attention masks every row past a slot's position, so the function
is the same) and reads nothing back; inside ``disabled()`` the buckets are
read on the host.

On a CPU tensor the same object runs ``fn`` eagerly through the same static
buffers: the plain version, which the tests hold against the JAX package.
Inside ``disabled()`` (the counterpart of ``jax.disable_jit()``) every
CapturedStep calls ``fn`` on its arguments directly: the eager form on the
card.

Launches: ``kernels/_build.py`` counts a launch in Python, so a replay by
itself counts nothing. The warm-up and the capture count nothing, and each
replay adds what the capture counted, so the counters read as after an
eager run. ``COUNTS`` holds the captures, replays, host seconds spent capturing
(``capture_s``, warm-up included) and the warm-ups' share of them
(``warmup_s``) since ``reset_counts()``.

The graph cache (the counterpart of JAX's jit cache with the cache
donated): ``entry(maker, trees, caches)`` gives one ``Entry`` a (maker,
parameter trees, trace-time settings, cache specs) key. An entry holds a
home cache of each cache's spec (its layout, dtype and buffer shapes) and
the CapturedSteps whose graphs read those home caches, so that graphs
outlive a call: ``sampling.generate``, ``make_decode_fns``' prefill and
``speculative.speculative_generate`` copy the caller's live rows into the
home caches (``copy_rows``), run every graph there and copy the rows back.
A tree is keyed by its identity, held while its entries live, and by the
address, shape, stride and dtype of every leaf: a leaf replaced in place
makes another key. The settings a forward reads on the host while it is
traced (``settings_key``) are part of the key, as JAX keys its cache on its
own config. The registry holds ``MAX_TREES`` trees (a target and its draft
count as one), each with ``MAX_ENTRIES`` entries, least recently used
first out; an evicted entry's graphs and home caches go with it.
``clear()`` (the counterpart of ``jax.clear_caches()``) drops them all.
"""
from __future__ import annotations

import contextlib
import enum
import gc
import itertools
import time
from collections import OrderedDict

import torch

from ..kernels import _build
from ..kernels import graph_switch as gs
from . import kv_cache as kvc

COUNTS = {"captures": 0, "replays": 0, "capture_s": 0.0, "warmup_s": 0.0,
          "switch_bodies": 0}
SWITCH = {"design": None}  # the parent graph the last switch build made
_DISABLED = [0]  # the depth of open disabled() contexts
_STREAMS: dict = {}  # device -> its capture stream
MAX_TREES = 2  # parameter trees (a target and its draft: one) the cache holds
MAX_ENTRIES = 2  # entries a tree
_REGISTRY: OrderedDict = OrderedDict()  # trees key -> _Trees


def reset_counts():
    COUNTS.update(captures=0, replays=0, capture_s=0.0, warmup_s=0.0,
                  switch_bodies=0)


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


class GraphPool:
    """A CUDA graph memory pool, made at its first capture. The graphs
    captured into one pool replay one at a time on one stream, and every
    caller reads a graph's outputs before the next replay, so they share
    the memory of their intermediates; the pool's memory goes when its
    last graph does."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


@contextlib.contextmanager
def collector_off():
    """Python's cyclic collector off for the block, a capture (left off if
    it was off): a dead graph in a reference cycle (an engine dropped with
    its CapturedSteps) destroyed by a collection inside a capture would
    invalidate it, since CUDA refuses to destroy a graph while a stream
    captures. Every capture of the package runs inside."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


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
        # normal tensors, so that calls in and out of inference mode share
        # them
        with torch.inference_mode(False):
            self.inputs = tuple(torch.empty_like(x) for x in inputs)
        self.outputs = None  # a tuple of tensors once fn has run
        self.single = False  # fn returned one tensor, not a tuple
        self.graph = None
        self.launches = None  # _build.launch_delta of one replay
        self.warmed = False  # the first call ran (warm_first_call)


class _Switch(_Graph):
    """One switched key: _Graph's buffers, the parent graph over its bodies
    and, for a sampled step, the prologue graph and each generator's draw
    a call."""

    def __init__(self, inputs):
        super().__init__(inputs)
        self.parent = None  # gs.ParentGraph
        self.prologue = None  # a CUDAGraph registering the generators
        self.advance = ()  # each generator's offset advance a call


class CapturedStep:
    def __init__(self, fn, state=(), generators=(), pool=None, device=None,
                 warm_first_call=False):
        """fn(*inputs, **key) -> tensor or tuple of tensors, capturable (no
        host sync). state: the tensors fn updates in place, restored after
        the warm-up before a capture. generators: the torch.Generators fn
        draws from, registered with every graph. pool: the GraphPool its
        graphs are captured into (default: one of its own). device: where
        fn runs when it takes no input (else its first input's device).
        warm_first_call: the first call of a key runs fn eagerly on the
        capture stream and is that key's warm-up: its result is returned
        and its updates kept (an optimizer's step), and the key is
        captured at its second call; ``state`` is then not restored."""
        self.fn = fn
        self.state = tuple(state)
        self.generators = tuple(generators)
        self.pool = pool or GraphPool()
        self.device = None if device is None else torch.device(device)
        self.warm_first_call = warm_first_call
        self._graphs: dict = {}
        self._switches: dict = {}

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
        dev = self._device(g)
        if dev is not None and dev.type == "cuda":
            if g.graph is None:
                if self.warm_first_call and not g.warmed:
                    g.warmed = True
                    return self._warm_call(g, key, dev)
                self._capture(g, key)
            self._replay(g)
        else:
            self._run_eagerly(g, key)
        return g.outputs[0] if g.single else g.outputs

    def _device(self, g):
        return g.inputs[0].device if g.inputs else self.device

    def release(self):
        """Drop every graph (their pool's memory goes with the last one)."""
        self._graphs.clear()
        self._switches.clear()

    def switch(self, bounds, *inputs, **key):
        """fn(*inputs, **key) with each Bound's keyword at the bucket its
        lengths select (kernels.graph_switch): on the card one parent
        graph a key, which picks the body on the device (the module
        docstring); on the CPU fn at the widest buckets; inside disabled()
        at the buckets read on the host."""
        bounds = tuple(bounds)
        if _DISABLED[0]:
            return self.fn(*inputs, **key, **gs.host_buckets(bounds))
        k = (tuple(sorted(key.items())),
             tuple((b.name, b.add, b.buckets, b.length.data_ptr())
                   for b in bounds))
        sw = self._switches.get(k)
        if sw is None:
            sw = self._switches[k] = _Switch(inputs)
        for static, x in zip(sw.inputs, inputs):
            if x is not static:
                static.copy_(x, non_blocking=True)
        dev = self._device(sw)
        if dev is not None and dev.type == "cuda":
            if sw.parent is None:
                self._capture_switch(sw, bounds, key, dev)
            self._launch_switch(sw)
        else:
            self._run_eagerly(sw, {**key, **{b.name: b.buckets[-1]
                                             for b in bounds}})
        return sw.outputs[0] if sw.single else sw.outputs

    def _warm_call(self, g, key, dev):
        """fn run eagerly on the capture stream: a key's first call under
        ``warm_first_call``; its launches count as an eager call's."""
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            outs = self.fn(*g.inputs, **key)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return outs

    def _run_eagerly(self, g, key):
        outs = self.fn(*g.inputs, **key)
        g.single = not isinstance(outs, tuple)
        outs = (outs,) if g.single else outs
        if g.outputs is None:
            with torch.inference_mode(False):
                g.outputs = tuple(torch.empty_like(o) for o in outs)
        for static, o in zip(g.outputs, outs):
            static.copy_(o)

    def _capture(self, g, key):
        t0 = time.perf_counter()
        dev = self._device(g)
        stream = capture_stream(dev)
        counts = _build.launch_counts()
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            if not self.warm_first_call:
                self._warm_up(g, key, stream)
                COUNTS["warmup_s"] += time.perf_counter() - t0  # host s
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                if not hasattr(graph, "register_generator_state"):
                    raise RuntimeError(
                        "CapturedStep: this torch cannot register a "
                        "generator with a CUDA graph "
                        "(CUDAGraph.register_generator_state)")
                graph.register_generator_state(gen)
            try:
                with collector_off(), torch.cuda.graph(
                        graph, pool=self.pool.handle(), stream=stream):
                    before = _build.launch_counts()
                    outs = self.fn(*g.inputs, **key)
                    after = _build.launch_counts()
            except RuntimeError as e:
                raise _capture_error(e) from e
        finally:
            _build.set_launch_counts(counts)
        torch.cuda.current_stream(dev).wait_stream(stream)
        g.single = not isinstance(outs, tuple)
        g.outputs = (outs,) if g.single else outs
        g.launches = _build.launch_delta(before, after)
        g.graph = graph
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += time.perf_counter() - t0

    def _capture_switch(self, sw, bounds, key, dev):
        """The bodies of a switched key, one a bucket combination (after
        one warm-up at the widest), and the parent graph over them."""
        t0 = time.perf_counter()
        stream = capture_stream(dev)
        names = [b.name for b in bounds]
        combos = list(itertools.product(*(b.buckets for b in bounds)))
        counts = _build.launch_counts()
        bodies, deltas = [], []
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            saved = [t.clone() for t in self.state]
            rng_saved = [gen.get_state() for gen in self.generators]
            offsets = [gen.get_offset() for gen in self.generators]
            with torch.cuda.stream(stream):
                outs = self.fn(*sw.inputs, **key,
                               **dict(zip(names, combos[-1])))
                for t, v in zip(self.state, saved):
                    t.copy_(v)
            sw.advance = tuple(gen.get_offset() - off for gen, off in
                               zip(self.generators, offsets))
            for gen, v in zip(self.generators, rng_saved):
                gen.set_state(v)
            sw.single = not isinstance(outs, tuple)
            outs = (outs,) if sw.single else outs
            with torch.inference_mode(False):
                sw.outputs = tuple(torch.empty_like(o) for o in outs)
            del outs
            COUNTS["warmup_s"] += time.perf_counter() - t0
            for combo in combos:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                for gen in self.generators:
                    graph.register_generator_state(gen)
                try:
                    with collector_off(), torch.cuda.graph(
                            graph, pool=self.pool.handle(), stream=stream):
                        before = _build.launch_counts()
                        outs = self.fn(*sw.inputs, **key,
                                       **dict(zip(names, combo)))
                        for static, o in zip(sw.outputs, (outs,) if sw.single
                                             else outs):
                            static.copy_(o)
                        after = _build.launch_counts()
                except RuntimeError as e:
                    raise _capture_error(e) from e
                del outs
                bodies.append(graph)
                deltas.append(_build.launch_delta(before, after))
            if self.generators:
                sw.prologue = torch.cuda.CUDAGraph()
                for gen in self.generators:
                    sw.prologue.register_generator_state(gen)
                with collector_off(), torch.cuda.graph(sw.prologue,
                                                       stream=stream):
                    for gen in self.generators:
                        torch.rand(1, generator=gen, device=dev)
        finally:
            _build.set_launch_counts(counts)
        torch.cuda.current_stream(dev).wait_stream(stream)
        if any(d != deltas[0] for d in deltas):
            raise RuntimeError(
                "CapturedStep.switch: the bodies launch different kernels "
                f"({deltas}); the switch counts one body's launches")
        sw.parent = gs.ParentGraph(bodies, bounds)
        SWITCH["design"] = sw.parent.design
        sw.launches = deltas[0]
        COUNTS["captures"] += 1
        COUNTS["switch_bodies"] += len(bodies)
        COUNTS["capture_s"] += time.perf_counter() - t0

    def _launch_switch(self, sw):
        offsets = [gen.get_offset() for gen in self.generators]
        if sw.prologue is not None:
            sw.prologue.replay()  # the generators' seed and offset written
        sw.parent.launch()
        for gen, off, adv in zip(self.generators, offsets, sw.advance):
            gen.set_offset(off + adv)
        _build.add_launches(sw.launches)
        COUNTS["replays"] += 1

    def _warm_up(self, g, key, stream):
        """fn once on the capture stream, then its state and generators
        put back."""
        saved = [t.clone() for t in self.state]
        rng_saved = [gen.get_state() for gen in self.generators]
        with torch.cuda.stream(stream):
            self.fn(*g.inputs, **key)
            for t, s in zip(self.state, saved):
                t.copy_(s)
        for gen, s in zip(self.generators, rng_saved):
            gen.set_state(s)

    def _replay(self, g):
        g.graph.replay()
        _build.add_launches(g.launches)
        COUNTS["replays"] += 1


def _capture_error(e: RuntimeError) -> RuntimeError:
    """The error a failed capture raises, naming its first cause (not
    capture_end's)."""
    cause = e
    while isinstance(cause.__context__, RuntimeError):
        cause = cause.__context__
    return RuntimeError(
        "CapturedStep: the step could not be captured into a CUDA graph (it "
        "must make no host sync: .item(), int() or .cpu() of a tensor, "
        "boolean-mask indexing; and use only capturable ops). Cause: "
        f"{str(cause).splitlines()[0]}")


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


# --- the graph cache -------------------------------------------------------

def _signature(node):
    """What a graph reads of a parameter tree: the address, shape, stride,
    dtype and device of every tensor (a QTensor's planes included), the
    tree's structure and its other leaves (a value, else the object's
    identity; the tree is held, so no identity is reused)."""
    if isinstance(node, torch.Tensor):
        return (node.data_ptr(), tuple(node.shape), node.stride(), node.dtype,
                node.device)
    if isinstance(node, dict):
        return tuple((k, _signature(node[k])) for k in sorted(node, key=str))
    if isinstance(node, (list, tuple)):
        return type(node).__name__, tuple(_signature(x) for x in node)
    planes = getattr(node, "planes", None)
    if isinstance(planes, dict):  # a QTensor
        return (type(node).__name__, node.gtype, node.shape,
                _signature(planes))
    if node is None or isinstance(node, (bool, int, float, str, enum.Enum)):
        return node
    return type(node).__name__, id(node)


def settings_key() -> tuple:
    """The switches a forward reads on the host while it is traced (its
    route, its kernels' modes, the tune table, the kernels' builds): a
    graph replays the function they chose at capture."""
    from .. import config
    from ..kernels import config as kcfg
    from ..kernels import tune

    key = (kcfg.kernels_setting(), kcfg.mm_dot_mode(),
           config.quantize_activations(), config.mlp_fused(),
           config.llama_fused(), config.layer_fused(), config.int_dot(),
           config.attn_impl(), tune.table_path(),
           tuple(sorted((k, d) for k, d in _build._DEFINES.items() if d)))
    if key[7] == "ring":
        from ..parallel.ring_attention import sequence_mesh

        key += (id(sequence_mesh()),)
    return key


def buffers(cache) -> tuple:
    """Every buffer of a KV cache, ``length`` first."""
    return (cache.length, *cache.k, *cache.v, *(cache.k_scale or ()),
            *(cache.v_scale or ()))


def cache_spec(cache) -> tuple:
    """A cache's layout, dtypes, device and buffer shapes: what a home
    cache must match."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in buffers(cache))


def home_like(cache) -> kvc.KVCache:
    """A zeroed cache of ``cache``'s spec (normal tensors, which calls in
    and out of inference mode can both write)."""
    def zeros(bufs):
        return None if bufs is None else [torch.zeros_like(x) for x in bufs]

    with torch.inference_mode(False):
        return kvc.KVCache(zeros(cache.k), zeros(cache.v),
                           zeros(cache.k_scale), zeros(cache.v_scale),
                           torch.zeros_like(cache.length))


def copy_rows(dst, src, n: int):
    """Rows [0, n) of every buffer of ``src`` (every slot) and its length
    into ``dst``, in place, on the current stream: what a graph over
    ``dst`` reads of ``src``. The rows past a slot's length are never read
    (attention masks by position), so the live rows are enough."""
    n = min(int(n), src.max_len)
    dim = 1 if src.is_flat else 2  # the row axis of every buffer
    if n > 0:
        for d, s in zip(buffers(dst)[1:], buffers(src)[1:]):
            d.narrow(dim, 0, n).copy_(s.narrow(dim, 0, n))
    dst.length.copy_(src.length)


class Entry:
    """One key of the graph cache: a home cache for each cache of the key
    (in its order) and the CapturedSteps whose graphs read them, by name,
    all captured into the entry's one GraphPool (``pool``); for a sampled
    round, the generator its graphs draw from."""

    def __init__(self, caches):
        self.homes = tuple(home_like(c) for c in caches)
        self.steps: dict = {}
        self.pool = GraphPool()
        self.generator = None

    def step(self, name, make):
        """The entry's CapturedStep ``name``, made by ``make(*homes)`` at
        its first call."""
        s = self.steps.get(name)
        if s is None:
            s = self.steps[name] = make(*self.homes)
        return s

    def own_generator(self, like: torch.Generator) -> torch.Generator:
        """The generator the entry's graphs register, on ``like``'s device
        (a caller's state is copied in and out around the graphs)."""
        if self.generator is None:
            self.generator = torch.Generator(device=like.device)
        return self.generator


class _Trees:
    def __init__(self, trees):
        self.trees = trees  # held, so that no identity is reused
        self.entries: OrderedDict = OrderedDict()


def entry(maker: tuple, trees: tuple, caches: tuple) -> Entry:
    """The graph cache's entry of (``maker``: the forwards, configs and
    what they make; the parameter ``trees``; the trace-time settings; the
    specs of ``caches``), made (with zeroed home caches) at its first
    call. Least recently used trees and entries beyond MAX_TREES and
    MAX_ENTRIES are evicted."""
    tkey = tuple((id(t), _signature(t)) for t in trees)
    held = _REGISTRY.get(tkey)
    if held is None:
        held = _REGISTRY[tkey] = _Trees(trees)
        while len(_REGISTRY) > MAX_TREES:
            _REGISTRY.popitem(last=False)
    else:
        _REGISTRY.move_to_end(tkey)
    key = (maker, settings_key(), tuple(cache_spec(c) for c in caches))
    e = held.entries.get(key)
    if e is None:
        e = held.entries[key] = Entry(caches)
        while len(held.entries) > MAX_ENTRIES:
            held.entries.popitem(last=False)
    else:
        held.entries.move_to_end(key)
    return e


def clear():
    """Drop every entry of the graph cache: its graphs, their pools and its
    home caches (the counterpart of ``jax.clear_caches()``; the memory goes
    back to PyTorch's allocator, ``torch.cuda.empty_cache()`` returns it to
    the device)."""
    _REGISTRY.clear()


def cache_info() -> dict:
    """The graph cache's trees, entries, static keys (graphs on the card;
    on the CPU the keys the CapturedSteps run eagerly) and the bytes its
    home caches hold."""
    entries = [e for held in _REGISTRY.values()
               for e in held.entries.values()]
    return {"trees": len(_REGISTRY), "entries": len(entries),
            "keys": sum(len(s._graphs) for e in entries
                        for s in e.steps.values()),
            "home_bytes": sum(t.numel() * t.element_size() for e in entries
                              for h in e.homes for t in buffers(h))}
