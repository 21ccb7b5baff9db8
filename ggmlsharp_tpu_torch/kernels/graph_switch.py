"""The in-graph length-bucket switch (``csrc/graph_switch.cu``): the
counterpart of the ``jax.lax.switch`` over ``_chunk_buckets`` that JAX
compiles into one executable for a ``prefix_bound=None`` call
(ggmlsharp_tpu/models/common.py:175-183).

A ``Bound`` names one static keyword of a step (``t_eff``, ``d_eff``), the
cache lengths it is read from, what a call adds to the longest of them
(1 for a decode step, S for a prefill of S tokens, k + 1 for a speculative
round) and the buckets its bodies were captured at. The index of a call is
JAX's ``sum(lim > b for b in buckets[:-1])``, lim = max(length) + add; two
bounds combine as ``idx0 * len(buckets1) + idx1`` (the bodies in
``itertools.product`` order).

``select_index`` is the plain version (torch ops on the lengths' device, no
host read), ``select`` runs the selector kernel alone on a CUDA tensor (a
check, counted ``graph_switch_select``), ``host_buckets`` reads the buckets
on the host (the eager form). ``ParentGraph`` builds, from the captured
bodies (``torch.cuda.CUDAGraph(keep_graph=True)``), the parent graph whose
selector picks one body at every launch; ``launch`` counts one
``graph_switch`` launch (its selector). ``design()`` says which parent the
toolkit builds: ``"switch"`` (one cudaGraphCondTypeSwitch node, CUDA 12.8)
or ``"if_chain"`` (one cudaGraphCondTypeIf node a body); ``set_design``
builds either on a toolkit that has both (the older toolkits' chain, checked
on a new one). A build that CUDA refuses raises RuntimeError naming the
CUDA error; nothing runs in its place.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

MAX_BUCKETS = 16  # csrc/graph_switch.cu: GS_MAX_BUCKETS, a bound's buckets
MAX_BODIES = 64  # GS_MAX_BODIES: bodies of one parent
_DESIGNS = {1: "switch", 2: "if_chain"}


class Bound(NamedTuple):
    """One switched keyword: ``name`` (the step's keyword), ``length`` (an
    int32 [B] tensor of cache lengths), ``add`` (lim = max(length) + add)
    and ``buckets`` (ascending; the last holds every lim)."""
    name: str
    length: torch.Tensor
    add: int
    buckets: tuple


def bucket_bound(name: str, length, add: int, buckets) -> Bound:
    """A Bound over the buckets a call can reach: those >= add (lim is at
    least add), the last one always."""
    buckets = tuple(int(b) for b in buckets)
    kept = tuple(b for b in buckets if b >= add) or buckets[-1:]
    if len(kept) > MAX_BUCKETS:
        raise ValueError(f"graph_switch: {len(kept)} buckets, at most "
                         f"{MAX_BUCKETS}")
    return Bound(name, length, int(add), kept)


def select_index(bounds) -> torch.Tensor:
    """The plain version of the selector: the combined body index, an int32
    0-d tensor on the lengths' device (no host read)."""
    idx = None
    for b in bounds:
        lim = b.length.max().to(torch.int32) + b.add
        j = torch.zeros((), dtype=torch.int32, device=lim.device)
        for edge in b.buckets[:-1]:  # JAX's sum(lim > b for b in ...)
            j = j + (lim > edge).to(torch.int32)
        idx = j if idx is None else idx * len(b.buckets) + j
    return idx


def host_buckets(bounds) -> dict:
    """Each bound's bucket read on the host: {name: bucket} (the eager
    form; one read a bound)."""
    out = {}
    for b in bounds:
        lim = int(b.length.max()) + b.add
        out[b.name] = next((t for t in b.buckets if lim <= t), b.buckets[-1])
    return out


def _axes(bounds) -> list:
    """The C arguments of one or two bounds: (lengths, n, add, buckets
    array, n buckets) for each, zeros for a missing second."""
    if not 1 <= len(bounds) <= 2:
        raise ValueError(f"graph_switch: {len(bounds)} bounds, 1 or 2")
    args, keep = [], []
    for b in bounds:
        if b.length.dtype != torch.int32 or not b.length.is_contiguous():
            raise ValueError("graph_switch: lengths must be contiguous int32")
        arr = (ctypes.c_int * len(b.buckets))(*b.buckets)
        keep.append(arr)
        args += [b.length.data_ptr(), b.length.numel(), b.add,
                 ctypes.addressof(arr), len(b.buckets)]
    if len(bounds) == 1:
        args += [None, 0, 0, None, 0]
    return args, keep


def error_text(rc: int) -> str:
    """CUDA error ``rc`` by name and text."""
    buf = ctypes.create_string_buffer(256)
    _build.entry("graph_switch_error")(rc, buf, len(buf))
    return f"CUDA error {rc} ({buf.value.decode()})"


def select(bounds) -> torch.Tensor:
    """The selector's index: the kernel on CUDA lengths (counted
    ``graph_switch_select``), the plain version on the CPU."""
    bounds = tuple(bounds)
    dev = bounds[0].length.device
    if dev.type != "cuda":
        return select_index(bounds)
    out = torch.empty((), dtype=torch.int32, device=dev)
    args, _keep = _axes(bounds)
    with torch.cuda.device(dev):
        rc = _build.entry("graph_switch_select")(
            *args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("graph_switch_select", rc)
    return out


def design() -> str:
    """The parent graph this build makes: "switch" or "if_chain"."""
    v = ctypes.c_int(0)
    _build.entry("graph_switch_design")(ctypes.addressof(v))
    return _DESIGNS[v.value]


def set_design(name: str | None = None):
    """Build the parents as ``name`` ("switch" or "if_chain") from now on:
    every entry of csrc/graph_switch.cu rebuilt with ``-DGS_SWITCH``; None
    gives the toolkit's choice back. Parents built before keep theirs."""
    flag = {None: None, "switch": 1, "if_chain": 0}[name]
    defines = () if flag is None else (f"GS_SWITCH={flag}",)
    for kernel, (src, _, _) in _build.KERNELS.items():
        if src == "graph_switch.cu":
            _build.set_defines(kernel, defines)


class ParentGraph:
    """The parent graph over ``bodies`` (torch CUDAGraphs captured with
    ``keep_graph=True``, in the combined-index order of ``bounds``),
    instantiated. Its selector reads the bounds' lengths at their
    addresses at every launch. The bodies are held: their memory pool
    holds the intermediates the parent's nodes address."""

    def __init__(self, bodies, bounds):
        bounds = tuple(bounds)
        n = 1
        for b in bounds:
            n *= len(b.buckets)
        if len(bodies) != n or n > MAX_BODIES:
            raise ValueError(f"graph_switch: {len(bodies)} bodies for {n} "
                             f"bucket combinations (at most {MAX_BODIES})")
        self.bodies = list(bodies)
        self.design = design()
        raw = (ctypes.c_void_p * n)(*[g.raw_cuda_graph() for g in bodies])
        args, _keep = _axes(bounds)
        handle = ctypes.c_void_p(0)
        self._destroy = _build.entry("graph_switch_destroy")
        rc = _build.entry("graph_switch_build")(
            ctypes.addressof(raw), n, *args, ctypes.addressof(handle))
        if rc != 0:
            raise RuntimeError(
                f"graph_switch: CUDA refused the parent graph "
                f"({self.design}, {n} bodies): {error_text(rc)}")
        self._handle = handle.value

    def launch(self):
        """One launch on the current stream: the selector, then the body it
        picks."""
        rc = _build.entry("graph_switch")(
            self._handle, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"graph_switch: launch failed with "
                               f"{error_text(rc)}")
        _build.check("graph_switch", rc)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._handle = None
            self._destroy(handle)
