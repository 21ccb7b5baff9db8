"""Quantized matmul: the CUDA kernels and their wrappers, for every weight
format.

Port of ggmlsharp_tpu/kernels/matmul_q.py. The JAX package has three TPU
layouts of one dequant-matmul (``_call_kernel_swar``, ``_call_kernel_planes``,
``_call_kernel``) and an exact integer-dot kernel (``_call_int_dot_kernel``).
The port has one row layout (quant.formats), so the dequant-matmul is one
function in three sources:

  * ``csrc/matmul_q4_0.cu`` (Q4_0) and ``csrc/matmul_q8_0.cu`` (Q8_0);
  * ``csrc/matmul_q.cu``: Q4_1, Q4_2, Q4_3, Q5_0, Q5_1, Q4_K and Q6_K, one
    template with a decode function a format.

Each computes ``y[b, n] = sum_k x[b, k] * w[n, k]`` in f32, w the weight
dequantized with the k-quants' fused f16 scales (``dequantize(...,
fused_scales=True)``). As in the JAX package, the ggml activation round trip
(Q8_0, Q8_1 or Q8_K) runs in plain PyTorch before the kernel. Their plain
version is ``ops.matmul.mul_mat_q``.

``csrc/matmul_int_dot.cu`` is ggml's vec_dot at one activation row
(``GGML_TPU_INT_DOT=1``, ``config.int_dot``): activations quantized to Q8_0
(Q8_1 for Q4_1/Q5_1), int8 x int8 block sums in int32, then
``sum_c f32(dw_c)·da_c·(S_c - off·sum q8_c) (+ sum_c m_c·s_c)``. Its plain
version is ``_int_dot_ref``. In the JAX package the switch takes effect only
with ``GGML_TPU_SWAR=0`` (its SWAR kernel comes first); the port has one
layout, so the switch alone selects the route.

At one activation row, ``csrc/matmul_q4_0.cu`` and ``csrc/matmul_q.cu``
run one streaming matrix-vector product (``csrc/dq_vec.cuh``: a lane a
whole 32-weight unit by a 16-byte load, x in shared memory, a persistent
grid over row groups); ``csrc/matmul_q8_0.cu`` its own. Each source is
compiled for every launch geometry of its kernel's ``tune.GEOMETRIES_OF``
(warps a block x weight rows a warp or a warp's group; all give the same
bits); a wrapper launches, at b = 1, the tune table's pair for the weight's
shape (``geometry``), else ``tune.DEFAULT``, and refuses a pair never
compiled.

From ``MMA_MIN_ROWS`` activation rows on (set by measurement: at 2 rows it
already beats the b = 1 kernel's 8-row pass at every 7B shape), every
dequant-matmul wrapper launches its source's multi-row instance instead
(``csrc/dq_mma.cuh``, entries ``matmul_q4_0_mma``, ``matmul_q8_0_mma`` and
``matmul_q_mma``, each with its own launch counter): bf16 mma.sync on the
tensor cores, weights on the M side, f32 x in three bf16 planes (exact), K
split ``mma_splits`` ways where the row tiles alone leave SMs idle. With the
Q8 activation round trip, ``mul_mat_q_fused`` hands it the int8 values and
their block scales instead (``mma_q8_matmul``): one exact plane; for Q8_0
weights the int8 tensor cores multiply those values by the weight bytes
directly. Q8_0 takes 64-row tiles, splits K ``q8_mma_splits`` ways and
runs one launch (its mma kernel splits f32 x into the planes itself and
reduces the K splits in a thread-block cluster), but for f32 x at a
weight as wide as the LM head, which takes the shared design.
It takes no launch geometry: a pair the caller names is still checked (a
pair never compiled raises) and otherwise ignored, and
``GEOMETRY_LAUNCHES`` records its launches with no pair. A row's bits are
the same at every b that takes it; against the b = 1 instance, which sums
in another order, they agree to f32 rounding.

``mm_dot`` (kernels.config): "f32" multiplies f32 x exactly (the three
planes; at b = 1 f32 FMAs), "bf16" rounds f32 x to bf16 once, where the
b = 1 instance loads it and into the multi-row instance's one plane, and
accumulates in f32. Q8 activations are exact in both. The dispatch
``mul_mat_q_fused`` passes the configured mode to the kernel and to the
plain version alike; the launch wrappers below take it as ``mode``
(default "f32", the function they computed before the switch was read).

A wrapper runs the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises (``kernels.config.use_kernel``).
"""
from __future__ import annotations

import torch

from .. import config
from ..dtypes import GType
from ..quant.formats import QTensor, plane_specs
from ..quant.quantize import dequantize, int_values, quantize
from . import _build, tune
from .config import H100_SMS, device_sms, mm_dot_mode, round_x, use_kernel

# the planes kernel A reads, in its argument order (C: ``Fmt``, GType's ids)
_PLANES = {
    GType.Q4_1: ("qs", "d", "m"),
    GType.Q4_2: ("qs", "d"),
    GType.Q4_3: ("qs", "d", "m"),
    GType.Q5_0: ("qs", "qh", "d"),
    GType.Q5_1: ("qs", "qh", "d", "m"),
    GType.Q4_K: ("qs", "scales", "d", "dmin"),
    GType.Q6_K: ("ql", "qh", "sc", "d"),
}
# weight format -> the kernel that computes its dequant-matmul
KERNEL_OF = {GType.Q4_0: "matmul_q4_0", GType.Q8_0: "matmul_q8_0",
             **dict.fromkeys(_PLANES, "matmul_q")}
INT_DOT_FORMATS = (GType.Q8_0, GType.Q4_0, GType.Q4_1, GType.Q5_0,
                   GType.Q5_1)
# the planes the b = 1 instance (csrc/dq_vec.cuh) reads by 16-byte loads,
# where they are not ("qs",)
_VEC_WIDE = {GType.Q6_K: ("ql", "qh")}
_INT_DOT_PLANES = ("qs", "qh", "d", "m")  # kernel B's order; absent: null
_INT_DOT_OFF = {GType.Q4_0: 8.0, GType.Q5_0: 16.0}  # value offsets
_INT_DOT_M = (GType.Q4_1, GType.Q5_1)  # Q8_1 activations, + sum m·s
# the multi-row instance (csrc/dq_mma.cuh): the activation rows from which
# it runs (below them the b = 1 instance), its weight rows a CTA (ROWS) and
# activation columns a chunk (KC, the unit of a K split)
MMA_MIN_ROWS = 2
MMA_ROWS = 128
MMA_KC = 256
_MMA_CTAS_PER_SM = 4  # mma_splits fills this many CTAs an SM,
_MMA_MAX_SPLITS = 8  # with at most this many splits (more: slower at N 4096)
# Q8_0's multi-row instance: weight rows a CTA, and the CTAs an SM its
# splits fill: one (its f32 route's CTAs are 512 threads). Chosen by a sweep
# of tiles at GPT-2's shapes (64 rows beat 128 and 32); PERF.md §6 PR 10
# times the result at GPT-2's and path f's Llama-7B shapes
MMA_ROWS_Q8 = 64
_Q8_CTAS_PER_SM = 1
# Q8 activation scales the multi-row instance reads: (format, scale dtype)
# -> (dqm::ScaleKind, columns a scale)
_Q8_SCALES = {(GType.Q8_0, torch.float16): (0, 32),
              (GType.Q8_1, torch.float32): (1, 32),
              (GType.Q8_K, torch.float32): (2, 256)}


def _check_x(name, x):
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned "
                         f"f32 [B, K] CUDA tensor")


def _check_planes(name, a: QTensor, keys, device):
    """Each plane of ``keys``: on ``device``, of its format's dtype and
    shape [N, columns], contiguous and 4-byte aligned."""
    n, k = a.shape
    specs = plane_specs(a.gtype, k)
    for key in keys:
        p = a[key]
        dtype, cols = specs[key]
        if p.device != device or p.dtype != dtype \
                or tuple(p.shape) != (n, cols) or not p.is_contiguous() \
                or p.data_ptr() % 4:
            raise ValueError(f"{name}: plane {key} {tuple(p.shape)} "
                             f"{p.dtype} on {p.device}; want ({n}, {cols}) "
                             f"{dtype}, contiguous, aligned, on {device}")


def geometry(kernel: str, n: int, k: int, gtype=None,
             b: int = 1) -> tuple[int, int]:
    """The launch geometry (warps a block, rows a warp) of dequant-matmul
    ``kernel`` at an [n, k] weight and b activation rows: at b = 1 the tune
    table's pair (``tune.lookup``), else ``tune.DEFAULT``. The table was
    timed on the sources' b = 1 instance (RB = 1); more rows run the
    multi-row instance, which takes no geometry. Every pair gives the same
    bits; the choice moves time only."""
    if b != 1:
        return tune.DEFAULT
    return tune.lookup(kernel, n, k, gtype) or tune.DEFAULT


def mma_splits(n: int, k: int, sms: int = H100_SMS) -> int:
    """K splits of the multi-row instance at an [n, k] weight on a card of
    ``sms`` SMs: enough to give ``_MMA_CTAS_PER_SM`` CTAs an SM where the
    row tiles (``MMA_ROWS`` rows each) are fewer, at most
    ``_MMA_MAX_SPLITS``, then as few as keep the most chunks (``MMA_KC``
    columns) a split takes (so 16 chunks go 4 x 4, not 4, 3, 3, 3, 3).
    Never 0. It reads neither b nor the format, so a row's sums run in the
    same order whatever rows share the launch."""
    if n < 1 or k < 1 or sms < 1:
        raise ValueError(f"mma_splits: n {n}, k {k}, sms {sms}")
    return _even_splits(-(-n // MMA_ROWS), k, _MMA_CTAS_PER_SM * sms)


def _even_splits(tiles: int, k: int, ctas: int) -> int:
    """Splits of K (``MMA_KC`` chunks) that bring ``tiles`` row tiles
    towards ``ctas`` CTAs, at most ``_MMA_MAX_SPLITS``, then as few as keep
    the most chunks a split takes."""
    chunks = -(-k // MMA_KC)
    want = max(1, min(ctas // tiles, _MMA_MAX_SPLITS, chunks))
    return -(-chunks // -(-chunks // want))


def q8_mma_splits(n: int, k: int, sms: int = H100_SMS) -> int:
    """K splits of Q8_0's multi-row instance at ``MMA_ROWS_Q8`` rows a CTA
    (both routes, but the LM head's f32 x): ``mma_splits``' rule towards
    ``_Q8_CTAS_PER_SM`` CTAs an SM, at most 8 (a portable cluster). Like
    it, a function of (n, k, sms) alone, never of b."""
    if n < 1 or k < 1 or sms < 1:
        raise ValueError(f"q8_mma_splits: n {n}, k {k}, sms {sms}")
    return _even_splits(-(-n // MMA_ROWS_Q8), k, _Q8_CTAS_PER_SM * sms)


def _mma_scratch_bytes(b: int, n: int, k: int, splits: int,
                       planes: int = 3) -> int:
    """Bytes of the multi-row instance's scratch (dq_mma.cuh): the
    activations' bf16 planes (3 for f32 x, 1 for Q8; rounded up to 16
    bytes), their 16-column sums and, for Q8, their 32-column scales (rows
    padded to a multiple of 4) and, when K is split, the partial sums."""
    pad4 = lambda v: -(-v // 4) * 4
    return -(-planes * b * k * 2 // 16) * 16 + b * pad4(k // 16) * 4 \
        + (b * pad4(k // 32) * 4 if planes == 1 else 0) \
        + (splits * b * n * 4 if splits > 1 else 0)


def _mma_plan(name, q8, b, n, k, sms, rx=0):
    """(the entry's arguments before the splits, K splits, scratch bytes)
    of the multi-row entry ``name`` for b activation rows (Q8, or f32 x:
    rx 1 rounds it to one bf16 plane, mm_dot "bf16", else three) of an
    [n, k] weight. Q8_0 names its tile: ``MMA_ROWS_Q8`` rows, one launch
    with no scratch (its splits reduced in clusters), but f32 x at a weight
    whose ``MMA_ROWS``-row tiles alone give every SM one (the LM head),
    which takes the shared split, mma and merge kernels."""
    planes = 1 if q8 or rx else 3
    if name != "matmul_q8_0_mma":
        splits = mma_splits(n, k, sms)
        return [], splits, _mma_scratch_bytes(b, n, k, splits, planes)
    if not q8 and -(-n // MMA_ROWS) >= sms:
        splits = mma_splits(n, k, sms)
        return [MMA_ROWS], splits, _mma_scratch_bytes(b, n, k, splits,
                                                      planes)
    return [MMA_ROWS_Q8], q8_mma_splits(n, k, sms), 0


def _launch_mma(name, fmt, acts, planes, n, mode="f32"):
    """Launch the multi-row instance ``name`` (operands checked by the
    caller): ``acts`` f32 x [B, K] (``mode`` its mm_dot function), or Q8
    activations (xq int8 [B, K], its block scales xd and their
    ``_Q8_SCALES`` kind); ``planes`` the weight's in the entry's order
    (None: unused), an [n, K] weight -> y f32 [B, n]. Recorded in
    ``GEOMETRY_LAUNCHES`` with no (warps, rows a warp) pair."""
    q8 = isinstance(acts, tuple)
    x, xq, xd, kind = (None, *acts) if q8 else (acts, None, None, 0)
    lead = xq if q8 else x
    B, K = lead.shape
    rx = 0 if q8 else round_x(mode)
    fn = _build.entry(name)
    extra, splits, nbytes = _mma_plan(name, q8, B, n, K,
                                      device_sms(lead.device), rx)
    y = torch.empty((B, n), dtype=torch.float32, device=lead.device)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=lead.device) \
        if nbytes else None
    ptr = lambda t: None if t is None else t.data_ptr()
    head = [] if fmt is None else [int(fmt)]
    with torch.cuda.device(lead.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*head, ptr(x), ptr(xq), ptr(xd), kind, *map(ptr, planes),
                y.data_ptr(), ptr(scratch), B, n, K, *extra, splits, rx,
                stream)
    _build.check(name, rc, geometry=(n, K, None, None, B))
    return y


def _check_vec(name, wide, n, k):
    """The b = 1 instance's own limits (csrc/dq_vec.cuh): its 16-byte
    quant planes ``wide`` 16-byte aligned, row offsets of every plane below
    2^31 bytes."""
    if any(p.data_ptr() % 16 for p in wide):
        raise ValueError(f"{name}: the quant planes must be 16-byte aligned")
    if n * (k // 2) >= 2 ** 31:
        raise ValueError(f"{name}: {n} x {k} is past the b = 1 instance's "
                         f"32-bit row offsets")


def _check_geometry(name, geom):
    """The pair as ints if ``name`` was compiled for it; raises otherwise,
    so no table entry reaches a launch with a geometry never built."""
    pair = tuple(int(v) for v in geom)
    pairs = tune.GEOMETRIES_OF[name]
    if pair not in pairs:
        raise ValueError(f"{name}: geometry {tuple(geom)} is not compiled; "
                         f"its source holds {pairs}")
    return pair


def _launch(name, x, qs, d, qs_dtype, qs_cols, gtype, geom=None,
            counter=None, mma=None, mode="f32"):
    """Check the operands of kernel ``name`` and launch it: x f32 [B, K], qs
    ``qs_dtype`` [N, qs_cols], d f16 [N, K/32] (all contiguous, on one card)
    -> y f32 [B, N]. geom: (warps, rows_per_warp); None: ``geometry``.
    counter: the launch counter (default ``name``; a probe's build
    of the source counts apart). mma: the source's multi-row entry, launched
    instead from ``MMA_MIN_ROWS`` rows on (an explicit geom is checked and
    otherwise ignored there). mode: the mm_dot function of x."""
    rx = round_x(mode)
    B, K = x.shape
    N = qs.shape[0]
    if not (x.is_cuda and qs.device == x.device and d.device == x.device):
        raise ValueError(f"{name}: x, qs and d must be on one CUDA device")
    if x.dtype != torch.float32 or qs.dtype != qs_dtype \
            or d.dtype != torch.float16:
        raise TypeError(f"{name}: got {x.dtype}, {qs.dtype}, {d.dtype}")
    if K % 32 or tuple(qs.shape) != (N, qs_cols) \
            or tuple(d.shape) != (N, K // 32):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"qs {tuple(qs.shape)}, d {tuple(d.shape)}")
    if not (x.is_contiguous() and qs.is_contiguous() and d.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if x.data_ptr() % 16 or qs.data_ptr() % 16 or d.data_ptr() % 2:
        raise ValueError(f"{name}: misaligned input")
    if mma is not None and B >= MMA_MIN_ROWS:
        if geom is not None:
            _check_geometry(name, geom)
        return _launch_mma(mma, None, x, (qs, d), N, mode)
    warps, rpw = _check_geometry(
        name, geometry(name, N, K, gtype, B) if geom is None else geom)
    if gtype != GType.Q8_0:
        _check_vec(name, [qs], N, K)
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), qs.data_ptr(), d.data_ptr(), y.data_ptr(),
                B, N, K, warps, rpw, rx, stream)
    _build.check(name, rc, counter, geometry=(N, K, warps, rpw, B))
    return y


def q4_0_matmul(x, qs, d, geom=None, mode="f32"):
    """Launch the Q4_0 kernel. x f32 [B, K]; qs uint8 [N, K/2]; d f16
    [N, K/32] -> y f32 [B, N]. geom: (warps, rows_per_warp), None:
    ``geometry`` (the tune table's at b = 1). From ``MMA_MIN_ROWS`` rows on
    the multi-row instance runs (counted as ``matmul_q4_0_mma``). mode: the
    mm_dot function ("f32" or "bf16")."""
    return _launch("matmul_q4_0", x, qs, d, torch.uint8, x.shape[1] // 2,
                   GType.Q4_0, geom, mma="matmul_q4_0_mma", mode=mode)


def q8_0_matmul(x, qs, d, geom=None, mode="f32"):
    """Launch the Q8_0 kernel. x f32 [B, K]; qs int8 [N, K]; d f16
    [N, K/32] -> y f32 [B, N]. geom and mode as for q4_0_matmul. From
    ``MMA_MIN_ROWS`` rows on the multi-row instance runs (counted as
    ``matmul_q8_0_mma``)."""
    return _launch("matmul_q8_0", x, qs, d, torch.int8, x.shape[1],
                   GType.Q8_0, geom, mma="matmul_q8_0_mma", mode=mode)


def q_matmul(x, a: QTensor, geom=None, mode="f32"):
    """Launch kernel A (``csrc/matmul_q.cu``) for a weight of a format in
    ``_PLANES``: x f32 [B, K] -> y f32 [B, N]. geom as for q4_0_matmul
    (the table's ``g<format>`` entry), mode likewise. From ``MMA_MIN_ROWS``
    rows on the multi-row instance runs (counted as ``matmul_q_mma``)."""
    name = "matmul_q"
    rx = round_x(mode)
    if a.gtype not in _PLANES:
        raise NotImplementedError(f"{name}: no decode for {a.gtype.name}")
    _check_x(name, x)
    n, k = a.shape
    if x.shape[1] != k or len(a.shape) != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} against {a.shape}")
    keys = _PLANES[a.gtype]
    _check_planes(name, a, keys, x.device)
    planes = [a[key] for key in keys] + [None] * (4 - len(keys))
    if x.shape[0] >= MMA_MIN_ROWS:
        if geom is not None:
            _check_geometry(name, geom)
        return _launch_mma("matmul_q_mma", a.gtype, x, planes, n, mode)
    warps, rpw = _check_geometry(
        name, geometry(name, n, k, a.gtype, x.shape[0]) if geom is None
        else geom)
    _check_vec(name, [a[key] for key in _VEC_WIDE.get(a.gtype, ("qs",))],
               n, k)
    ptrs = [p.data_ptr() for p in planes[:len(keys)]] \
        + [None] * (4 - len(keys))
    y = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(a.gtype), x.data_ptr(), *ptrs, y.data_ptr(), x.shape[0],
                n, k, warps, rpw, rx, stream)
    _build.check(name, rc, geometry=(n, k, warps, rpw, x.shape[0]))
    return y


def mma_q8_matmul(a: QTensor, aq: QTensor):
    """The multi-row instance on Q8 activations: ``aq`` [B, K], x quantized
    to the weight's vec_dot type (Q8_0, Q8_1 or Q8_K), times ``a`` (Q4_0,
    Q8_0 or a format of ``_PLANES``) -> y f32 [B, N], the function
    ``dequantize(aq) @ dequantize(a, fused_scales=True).T``. The int8 values
    take one bf16 plane (exact) and each block's activation scale folds with
    the weight's; for Q8_0 weights the int8 tensor cores take the values
    themselves (16-byte aligned) and the block's two scales fold with its
    exact int32 sum."""
    name = {GType.Q4_0: "matmul_q4_0_mma",
            GType.Q8_0: "matmul_q8_0_mma"}.get(a.gtype, "matmul_q_mma")
    own = name != "matmul_q_mma"  # a source of one format: no format id
    if not own and a.gtype not in _PLANES:
        raise NotImplementedError(f"{name}: no decode for {a.gtype.name}")
    n, k = a.shape
    xq = aq["qs"]
    align = 16 if a.gtype == GType.Q8_0 else 4
    if not xq.is_cuda or xq.dtype != torch.int8 or xq.dim() != 2 \
            or xq.shape[1] != k or not xq.is_contiguous() \
            or xq.data_ptr() % align or len(a.shape) != 2:
        raise ValueError(f"{name}: Q8 activations {tuple(xq.shape)} "
                         f"{xq.dtype} do not fit {a.shape}")
    xd = aq["d"]
    kind, cols = _Q8_SCALES.get((aq.gtype, xd.dtype), (None, 1))
    if kind is None or tuple(xd.shape) != (xq.shape[0], k // cols) \
            or not xd.is_contiguous() or xd.device != xq.device \
            or xd.data_ptr() % xd.element_size():
        raise ValueError(f"{name}: Q8 scales {tuple(xd.shape)} {xd.dtype} "
                         f"of {aq.gtype.name} do not fit")
    keys = ("qs", "d") if own else _PLANES[a.gtype]
    _check_planes(name, a, keys, xq.device)
    planes = [a[key] for key in keys] + [None] * (4 - len(keys)) * (not own)
    return _launch_mma(name, None if own else a.gtype, (xq, xd, kind),
                       planes, n)


def fused_supported(a: QTensor) -> bool:
    """Whether a CUDA kernel takes the dequant-matmul of ``a`` (the JAX
    gate's type and shape clauses; its TPU tile clauses have no
    counterpart)."""
    return isinstance(a, QTensor) and a.gtype in KERNEL_OF \
        and len(a.shape) == 2


def int_dot_supported(a: QTensor, batch: int) -> bool:
    """The JAX gate of the integer-dot route without its TPU tile clauses:
    one activation row and a format the kernel decodes."""
    return batch == 1 and isinstance(a, QTensor) \
        and a.gtype in INT_DOT_FORMATS and len(a.shape) == 2


def int_dot_acts(a: QTensor, x):
    """The route's activation quantization (ggml's INIT phase, as the JAX
    package's ``mul_mat_q_int_dot``): x f32 [K] -> (q int8 [K], d f32
    [K/32], s f32 [K/32] for Q4_1/Q5_1 else None); Q8_0's d is its stored
    f16 value."""
    if a.gtype in _INT_DOT_M:
        aq = quantize(x, GType.Q8_1)
        return aq["qs"], aq["d"], aq["s"]
    aq = quantize(x, GType.Q8_0)
    return aq["qs"], aq["d"].to(torch.float32), None


def _int_dot_ref(a: QTensor, xq, da, xs):
    """Kernel B's plain version, y f32 [N]. The int8 block sums are f32
    matmuls over integer values, exact while |S_c| < 2^24 (at most 32 ·
    31 · 128 here), then the f32 scale products as the JAX kernel takes
    them."""
    n, k = a.shape
    v = int_values(a).to(torch.float32).reshape(n, k // 32, 32)
    q = xq.to(torch.float32).reshape(k // 32, 32)
    s = torch.einsum("ncl,cl->nc", v, q)
    off = _INT_DOT_OFF.get(a.gtype)
    if off:
        s = s - off * q.sum(dim=-1)
    y = torch.sum(a["d"].to(torch.float32) * da * s, dim=-1)
    if a.gtype in _INT_DOT_M:
        y = y + torch.sum(a["m"].to(torch.float32) * xs, dim=-1)
    return y


def int_dot_launch(a: QTensor, xq, da, xs):
    """Launch kernel B (``csrc/matmul_int_dot.cu``): xq int8 [K], da f32
    [K/32], xs f32 [K/32] or None -> y f32 [N]."""
    name = "matmul_int_dot"
    if a.gtype not in INT_DOT_FORMATS or len(a.shape) != 2:
        raise NotImplementedError(f"{name}: no decode for {a.gtype.name}")
    n, k = a.shape
    dev = xq.device
    c = k // 32
    if not xq.is_cuda or xq.dtype != torch.int8 or tuple(xq.shape) != (k,) \
            or da.dtype != torch.float32 or tuple(da.shape) != (c,) \
            or da.device != dev or (xs is None) == (a.gtype in _INT_DOT_M):
        raise ValueError(f"{name}: activations do not fit {a.shape}")
    acts = [xq, da] + ([] if xs is None else [xs])
    if any(not t.is_contiguous() or t.data_ptr() % 4 for t in acts) or (
            xs is not None and (xs.dtype != torch.float32
                                or tuple(xs.shape) != (c,)
                                or xs.device != dev)):
        raise ValueError(f"{name}: activations must be contiguous, aligned")
    _check_planes(name, a, [k for k in _INT_DOT_PLANES if k in a.planes],
                  dev)
    if xq.data_ptr() % 16 or a["qs"].data_ptr() % 16:
        raise ValueError(f"{name}: xq and qs must be 16-byte aligned")
    planes = [a[k].data_ptr() if k in a.planes else None
              for k in _INT_DOT_PLANES]
    y = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _build.entry(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(a.gtype), xq.data_ptr(), da.data_ptr(),
                None if xs is None else xs.data_ptr(), *planes, y.data_ptr(),
                n, k, stream)
    _build.check(name, rc)
    return y


def int_dot_matmul(a: QTensor, x, plain: bool = False):
    """ggml's exact quantized dot of one activation row: x f32 [1, K] ->
    y f32 [1, N]. Kernel B for a CUDA tensor, ``_int_dot_ref`` for a CPU
    tensor or with plain=True."""
    if x.shape[0] != 1:
        raise ValueError(f"int_dot_matmul: one row, got {tuple(x.shape)}")
    xq, da, xs = int_dot_acts(a, x[0])
    if not use_kernel(x, plain):
        return _int_dot_ref(a, xq, da, xs)[None]
    return int_dot_launch(a, xq, da, xs)[None]


def mul_mat_q_fused(a: QTensor, bx, quantize_acts: bool = True,
                    plain: bool = False, mode: str | None = None):
    """Quantized mul_mat: a [n, k] QTensor, bx [..., k] -> f32 [..., n].
    One activation row with quantized activations under GGML_TPU_INT_DOT=1
    takes the integer-dot route (its plain version for a CPU tensor or with
    plain=True); everything else the dequant-matmul of a's format (plain
    version: ops.matmul.mul_mat_q), with quantized activations from
    ``MMA_MIN_ROWS`` rows on through ``mma_q8_matmul``. Float activations
    take mm_dot ``mode`` (None: the configured one), in kernel and plain
    version alike."""
    mode = mm_dot_mode() if mode is None else mode
    n, k = a.shape
    x = bx.to(torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if quantize_acts and config.int_dot() \
            and int_dot_supported(a, x2.shape[0]):
        return int_dot_matmul(a, x2, plain=plain).reshape(*lead, n)
    if not use_kernel(bx, plain):
        from ..ops.matmul import mul_mat_q

        return mul_mat_q(a, bx, quantize_acts=quantize_acts, mode=mode)
    if not fused_supported(a):
        raise NotImplementedError(f"no CUDA kernel for {a.gtype.name} "
                                  f"weights of shape {a.shape}")
    if quantize_acts:
        from ..ops.matmul import quantize_activations

        aq = quantize_activations(x2, a.gtype)
        if x2.shape[0] >= MMA_MIN_ROWS and a.gtype in KERNEL_OF:
            return mma_q8_matmul(a, aq).reshape(*lead, n)
        x2 = dequantize(aq)
    # the Q8 round trip's values are exact: rounded by neither mode
    mode = "f32" if quantize_acts else mode
    x2 = x2.contiguous()
    if a.gtype == GType.Q4_0:
        y = q4_0_matmul(x2, a["qs"], a["d"], mode=mode)
    elif a.gtype == GType.Q8_0:
        y = q8_0_matmul(x2, a["qs"], a["d"], mode=mode)
    else:
        y = q_matmul(x2, a, mode=mode)
    return y.reshape(*lead, n)
