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

The three dequant-matmul sources are compiled for every launch geometry
of ``tune.GEOMETRIES`` (warps a block x weight rows a warp; all give the same
bits); a wrapper launches, at b = 1, the tune table's pair for the weight's
shape (``geometry``), else ``tune.DEFAULT``, and refuses a pair never
compiled.

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
from .config import use_kernel

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
_INT_DOT_PLANES = ("qs", "qh", "d", "m")  # kernel B's order; absent: null
_INT_DOT_OFF = {GType.Q4_0: 8.0, GType.Q5_0: 16.0}  # value offsets
_INT_DOT_M = (GType.Q4_1, GType.Q5_1)  # Q8_1 activations, + sum m·s


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
    timed on the sources' b = 1 instance (RB = 1); more rows run the RB = 8
    instance, which no sweep measured. Every pair gives the same bits; the
    choice moves time only."""
    if b != 1:
        return tune.DEFAULT
    return tune.lookup(kernel, n, k, gtype) or tune.DEFAULT


def _check_geometry(name, geom):
    """The pair as ints if ``name`` was compiled for it; raises otherwise,
    so no table entry reaches a launch with a geometry never built."""
    pair = tuple(int(v) for v in geom)
    if pair not in tune.GEOMETRIES:
        raise ValueError(f"{name}: geometry {tuple(geom)} is not compiled; "
                         f"the sources hold {tune.GEOMETRIES}")
    return pair


def _launch(name, x, qs, d, qs_dtype, qs_cols, gtype, geom=None,
            counter=None):
    """Check the operands of kernel ``name`` and launch it: x f32 [B, K], qs
    ``qs_dtype`` [N, qs_cols], d f16 [N, K/32] (all contiguous, on one card)
    -> y f32 [B, N]. geom: (warps, rows_per_warp); None: ``geometry``.
    counter: the launch counter (default ``name``; a probe's build
    of the source counts apart)."""
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
    warps, rpw = _check_geometry(
        name, geometry(name, N, K, gtype, B) if geom is None else geom)
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), qs.data_ptr(), d.data_ptr(), y.data_ptr(),
                B, N, K, warps, rpw, stream)
    _build.check(name, rc, counter, geometry=(N, K, warps, rpw, B))
    return y


def q4_0_matmul(x, qs, d, geom=None):
    """Launch the Q4_0 kernel. x f32 [B, K]; qs uint8 [N, K/2]; d f16
    [N, K/32] -> y f32 [B, N]. geom: (warps, rows_per_warp), None:
    ``geometry`` (the tune table's at b = 1)."""
    return _launch("matmul_q4_0", x, qs, d, torch.uint8, x.shape[1] // 2,
                   GType.Q4_0, geom)


def q8_0_matmul(x, qs, d, geom=None):
    """Launch the Q8_0 kernel. x f32 [B, K]; qs int8 [N, K]; d f16
    [N, K/32] -> y f32 [B, N]. geom as for q4_0_matmul."""
    return _launch("matmul_q8_0", x, qs, d, torch.int8, x.shape[1],
                   GType.Q8_0, geom)


def q_matmul(x, a: QTensor, geom=None):
    """Launch kernel A (``csrc/matmul_q.cu``) for a weight of a format in
    ``_PLANES``: x f32 [B, K] -> y f32 [B, N]. geom as for q4_0_matmul
    (the table's ``g<format>`` entry)."""
    name = "matmul_q"
    if a.gtype not in _PLANES:
        raise NotImplementedError(f"{name}: no decode for {a.gtype.name}")
    _check_x(name, x)
    n, k = a.shape
    if x.shape[1] != k or len(a.shape) != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} against {a.shape}")
    keys = _PLANES[a.gtype]
    _check_planes(name, a, keys, x.device)
    warps, rpw = _check_geometry(
        name, geometry(name, n, k, a.gtype, x.shape[0]) if geom is None
        else geom)
    ptrs = [a[key].data_ptr() for key in keys] + [None] * (4 - len(keys))
    y = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(a.gtype), x.data_ptr(), *ptrs, y.data_ptr(), x.shape[0],
                n, k, warps, rpw, stream)
    _build.check(name, rc, geometry=(n, k, warps, rpw, x.shape[0]))
    return y


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
                    plain: bool = False):
    """Quantized mul_mat: a [n, k] QTensor, bx [..., k] -> f32 [..., n].
    One activation row with quantized activations under GGML_TPU_INT_DOT=1
    takes the integer-dot route (its plain version for a CPU tensor or with
    plain=True); everything else the dequant-matmul of a's format (plain
    version: ops.matmul.mul_mat_q)."""
    n, k = a.shape
    x = bx.to(torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if quantize_acts and config.int_dot() \
            and int_dot_supported(a, x2.shape[0]):
        return int_dot_matmul(a, x2, plain=plain).reshape(*lead, n)
    if not use_kernel(bx, plain):
        from ..ops.matmul import mul_mat_q

        return mul_mat_q(a, bx, quantize_acts=quantize_acts)
    if not fused_supported(a):
        raise NotImplementedError(f"no CUDA kernel for {a.gtype.name} "
                                  f"weights of shape {a.shape}")
    if quantize_acts:
        from ..ops.matmul import quantize_activations

        x2 = dequantize(quantize_activations(x2, a.gtype))
    x2 = x2.contiguous()
    if a.gtype == GType.Q4_0:
        y = q4_0_matmul(x2, a["qs"], a["d"])
    elif a.gtype == GType.Q8_0:
        y = q8_0_matmul(x2, a["qs"], a["d"])
    else:
        y = q_matmul(x2, a)
    return y.reshape(*lead, n)
