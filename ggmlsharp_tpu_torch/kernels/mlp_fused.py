"""Fused MLPs, one launch each: the GELU MLP over a Q8_0 weight pair (CUDA
kernel ``csrc/mlp_fused_q8.cu``, port of
ggmlsharp_tpu/kernels/mlp_fused.py::flash_ff_q8) and the SwiGLU MLP over a
Q4_0 pair (``csrc/mlp_fused_silu_q4.cu``, port of ::flash_ff_silu_q4).

``y = gelu(x·W1ᵀ + b1)·W2ᵀ + b2``. The input gets the same optional Q8_0
activation round trip as an unfused matmul, in plain PyTorch before the
kernel; the intermediate h stays f32 and is never re-quantized. f32 x
takes the configured mm_dot function (kernels.config: "bf16" rounds it to
bf16 once), the Q8_0 round trip's values are exact either way. Both
weights are read in the block's one Q8_0 copy (``qs`` int8 [N, K], ``d``
f16 [N, K/32]): the JAX package's permuted, packed planes exist for the
TPU's vector units only. One activation row takes the source's one-launch
kernel, one persistent CTA an SM that copies its shares of both weights
into shared memory at entry and exchanges h between CTAs as tagged words
(``gpt2_layer.cu``'s design: ``mlp_smem_plan`` places the shares,
``gpt2_layer.place``; the tags and the exchange live in
``_sync.sync_buffer`` and ``_sync.exchange_buffer``); from
``matmul_q.MMA_MIN_ROWS`` rows on the wrapper launches its
multi-row instance on the tensor cores (entry ``mlp_fused_q8_mma``, its
own launch counter; ``csrc/dq_mma.cuh``): W1 as ``matmul_q8_0_mma``'s
single-launch routes (Q8_0 activations, handed over as values and scales,
on the int8 tensor cores; f32 x in bf16 planes), whose epilogue writes
gelu(sum + b1), then W2 over that f32 h in its three exact planes, with
b2 in the epilogue: two launches.

``flash_ff_silu_q4``: ``y = (silu(x·Wgᵀ) ⊙ (x·Wuᵀ))·Wdᵀ`` with
``w_gate_up = [Wg; Wu]`` (2F, E) and ``w_down`` (E, F), both Q4_0, read in
the block's one copy (the JAX planes are row permutations of the same
payload, which the gated product makes invisible). The input gets the
optional activation round trip outside the kernel; the gate and up rows and
the gated product stay f32 and are never re-quantized, unlike the unfused
route, whose ``w_down`` matmul quantizes its input. One activation row
(decode) takes the source's one-launch kernel (both products on the
streaming matvec of ``csrc/dq_vec.cuh``, the gated product handed between
them in the launch; ``silu_one_row_smem`` the shared memory it needs); from
``matmul_q.MMA_MIN_ROWS`` rows on the wrapper launches its multi-row
instance on the tensor cores (entry ``mlp_fused_silu_q4_mma``, its own
launch counter; ``csrc/dq_mma.cuh``): the gate/up and down products as
``matmul_q4_0_mma``'s passes, K split ``mma_splits`` ways each (never by
rows), and between them a kernel that adds the gate/up splits, pairs gate
row n with up row F + n and writes silu(g)·u as the down product's exact
bf16 planes. With the activation round trip it is handed the Q8_0 values
and block scales themselves, as ``matmul_q.mma_q8_matmul`` is; the wrapper
allocates its scratch (``_mlp_scratch_bytes``).

The plain versions are ``_ff_ref`` (in either mm_dot mode) and
``_ff_silu_ref``. A wrapper runs its
plain version for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from ..dtypes import GType
from ..ops.basic import gelu, silu
from ..ops.matmul import mul_mat_q, quantize_activations
from ..quant.formats import QTensor
from ..quant.quantize import dequantize
import ctypes

from . import _build
from ._sync import exchange_buffer, sync_buffer
from .config import device_sms, mm_dot_mode, round_x, use_kernel
from .gpt2_layer import device_smem, place
from .matmul_q import (MMA_MIN_ROWS, _mma_scratch_bytes, mma_splits,
                       q8_mma_splits)

_MAX_FUSED_B = 64  # h is a [rows, n1] f32 scratch; prefill beyond it is unfused
_SMEM_MAX = 232448  # the shared memory an H100 CTA may opt into (csrc/dq_vec.cuh SMEM_MAX)
_PLANS: dict = {}  # (k1, n1, n2, ctas, smem) -> (SmemPlan, its ctypes ints, cw)
# the one-row instance's consumer warps (csrc/mlp_fused_q8.cu CW_FEW,
# CW_MANY): the many where a CTA's share of W1 passes _FEW_ROWS rows
_CONSUMER_WARPS = (12, 20)
_FEW_ROWS = 32
# the plan as the kernel copies it into shared memory (csrc/shares.cuh Plan)
_PLAN_BYTES = (12 + 7 * 64) * 4


def mlp_fuse_supported(w1, w2, b: int | None = None) -> bool:
    """True if (w1, w2) can go through the fused kernel: a pair of 2-D Q8_0
    QTensors with w1 [n1, k1], w2 [n2, n1], and at most _MAX_FUSED_B rows."""
    if not (isinstance(w1, QTensor) and isinstance(w2, QTensor)):
        return False
    if w1.gtype != GType.Q8_0 or w2.gtype != GType.Q8_0:
        return False
    if len(w1.shape) != 2 or len(w2.shape) != 2 or w2.shape[1] != w1.shape[0]:
        return False
    return b is None or b <= _MAX_FUSED_B


def _ff_ref(w1, b1, w2, b2, x, quantize_acts: bool = True,
            mode: str = "f32"):
    """Plain version: two dequantized f32 matmuls around the GELU, the first
    in mm_dot ``mode``; h is neither re-quantized nor rounded."""
    h = gelu(mul_mat_q(w1, x, quantize_acts=quantize_acts, mode=mode) + b1)
    return mul_mat_q(w2, h, quantize_acts=False) + b2


def _bias_pair(b1, b2):
    """Both biases in one dtype the kernel reads (f32 or bf16)."""
    if b1.dtype == b2.dtype and b1.dtype in (torch.float32, torch.bfloat16):
        return b1.contiguous(), b2.contiguous()
    return b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()


def consumer_warps(n1: int, ctas: int) -> int:
    """The one-row instance's consumer warps for W1 of n1 rows on ``ctas``
    CTAs: 12 where a CTA's share of W1 has at most _FEW_ROWS rows (16
    two-row units or fewer), else 20 (on an H100, 124M 7.2-7.4 µs with 12
    against 7.6-7.8 with 20; 774M 11.6 with 20 against 12.6 with 16:
    PERF.md §6)."""
    few, many = _CONSUMER_WARPS
    return few if -(-n1 // ctas) <= _FEW_ROWS else many


def mlp_smem_plan(k1: int, n1: int, n2: int, ctas: int, smem: int):
    """The one-row instance's shared-memory plan (``gpt2_layer.place``) for
    W1 [n1, k1] and W2 [n2, n1] on ``ctas`` CTAs of at most ``smem`` bytes
    and ``consumer_warps(n1, ctas)`` consumer warps: the activation vector
    (x, then h), the partial sums, the plan's own copy, and the CTA's
    shares of both weights, W1's first, a ring of pieces where they do not
    fit at once. ValueError for widths the kernel does not take: a
    scale plane whose bytes are no multiple of 16 (a share's scales are
    copied in 16-byte bounds), more CTAs than rows of W1 (each CTA writes
    some of h), or shares that no ring of pieces fits."""
    if k1 % 32 or n1 % 32 or n1 * k1 % 256 or n2 * n1 % 256 or ctas > n1:
        raise ValueError(f"mlp_smem_plan: W1 [{n1}, {k1}], W2 [{n2}, {n1}] "
                         f"on {ctas} CTAs")
    return place(((n1, k1), (n2, n1)), ctas, smem, max(k1, n1) * 4,
                 _PLAN_BYTES, cw=consumer_warps(n1, ctas))


def _device_plan(k1: int, n1: int, n2: int, device):
    """(mlp_smem_plan for ``device``, at most one CTA an SM, its ctypes
    copy, its consumer warps), made once and kept."""
    sms, smem = device_smem(device)
    ctas = min(sms, n1)
    key = (k1, n1, n2, ctas, smem)
    got = _PLANS.get(key)
    if got is None:
        plan = mlp_smem_plan(k1, n1, n2, ctas, smem)
        ints = plan.ints()
        got = (plan, (ctypes.c_int * len(ints))(*ints),
               consumer_warps(n1, ctas))
        _PLANS[key] = got
    return got


def mlp_fused_q8(x, w1: QTensor, b1, w2: QTensor, b2, mode: str = "f32"):
    """Launch the kernel. x [B, k1] on the card, B <= _MAX_FUSED_B: f32,
    contiguous, or (from ``MMA_MIN_ROWS`` rows on) the Q8_0 activations
    ``quantize_activations(x, Q8_0)``; mode: the mm_dot function of f32 x
    -> y f32 [B, n2]. One row launches the b = 1 instance, more the
    multi-row one (counted as ``mlp_fused_q8_mma``)."""
    q8 = isinstance(x, QTensor)
    lead = x["qs"] if q8 else x
    rx = round_x(mode)
    if not mlp_fuse_supported(w1, w2, lead.shape[0]):
        raise ValueError(f"mlp_fused_q8: unsupported pair {w1!r}, {w2!r} "
                         f"or rows {lead.shape[0]}")
    B, k1 = lead.shape
    n1, n2 = w1.shape[0], w2.shape[0]
    tensors = (lead, w1["qs"], w1["d"], b1, w2["qs"], w2["d"], b2)
    if not lead.is_cuda or any(t.device != lead.device for t in tensors):
        raise ValueError("mlp_fused_q8: all inputs must be on one CUDA device")
    if lead.dtype != (torch.int8 if q8 else torch.float32) \
            or k1 != w1.shape[1] or not lead.is_contiguous():
        raise ValueError(f"mlp_fused_q8: x {tuple(lead.shape)} {lead.dtype}")
    if tuple(b1.shape) != (n1,) or tuple(b2.shape) != (n2,):
        raise ValueError("mlp_fused_q8: bias shapes")
    if not all(w[p].is_contiguous() for w in (w1, w2) for p in ("qs", "d")):
        raise ValueError("mlp_fused_q8: weights must be contiguous")
    if lead.data_ptr() % 16 or w1["qs"].data_ptr() % 16 \
            or w2["qs"].data_ptr() % 16:
        raise ValueError("mlp_fused_q8: misaligned input")
    b1, b2 = _bias_pair(b1, b2)
    bias_bf16 = int(b1.dtype == torch.bfloat16)
    y = torch.empty((B, n2), dtype=torch.float32, device=lead.device)
    if B >= MMA_MIN_ROWS:
        name = "mlp_fused_q8_mma"
        xd = None
        if q8:
            xd = x["d"]
            if x.gtype != GType.Q8_0 or xd.dtype != torch.float16 \
                    or tuple(xd.shape) != (B, k1 // 32) \
                    or not xd.is_contiguous() or xd.device != lead.device:
                raise ValueError(f"{name}: Q8 scales {tuple(xd.shape)} "
                                 f"{xd.dtype} of {x.gtype.name} do not fit")
        h = torch.empty((B, n1), dtype=torch.float32, device=lead.device)
        fn = _build.entry(name)
        sms = device_sms(lead.device)
        acts = (None, lead.data_ptr(), xd.data_ptr()) if q8 \
            else (lead.data_ptr(), None, None)
        with torch.cuda.device(lead.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(*acts, w1["qs"].data_ptr(), w1["d"].data_ptr(),
                    b1.data_ptr(), w2["qs"].data_ptr(), w2["d"].data_ptr(),
                    b2.data_ptr(), h.data_ptr(), y.data_ptr(), B, k1, n1, n2,
                    bias_bf16, q8_mma_splits(n1, k1, sms),
                    q8_mma_splits(n2, n1, sms), 0 if q8 else rx, stream)
        _build.check(name, rc)
        return y
    if q8:
        raise ValueError("mlp_fused_q8: Q8_0 activations take "
                         f"{MMA_MIN_ROWS} or more rows")
    if w1["d"].data_ptr() % 16 or w2["d"].data_ptr() % 16:
        raise ValueError("mlp_fused_q8: misaligned scales")
    fn = _build.entry("mlp_fused_q8")
    _, plan, cw = _device_plan(k1, n1, n2, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        sync = sync_buffer(x.device, stream)
        xh = exchange_buffer(x.device, stream, n1)
        rc = fn(x.data_ptr(), w1["qs"].data_ptr(), w1["d"].data_ptr(),
                b1.data_ptr(), w2["qs"].data_ptr(), w2["d"].data_ptr(),
                b2.data_ptr(), xh.data_ptr(), y.data_ptr(), B, k1, n1, n2,
                bias_bf16, rx, sync.data_ptr(), plan, cw, stream)
    _build.check("mlp_fused_q8", rc)
    return y


def flash_ff_q8(w1: QTensor, b1, w2: QTensor, b2, x,
                quantize_acts: bool = True, mode: str | None = None):
    """Apply the fused MLP to x [..., k1] -> f32 [..., n2]; mode: the
    mm_dot function of f32 x (None: the configured one). With
    quantize_acts, one row is handed its dequantized Q8_0 round trip, more
    rows the Q8_0 values and scales themselves."""
    mode = mm_dot_mode() if mode is None else mode
    if not use_kernel(x):
        return _ff_ref(w1, b1, w2, b2, x, quantize_acts, mode)
    k1 = w1.shape[1]
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, k1)
    if quantize_acts:
        aq = quantize_activations(x2, GType.Q8_0)
        if x2.shape[0] >= MMA_MIN_ROWS:
            y = mlp_fused_q8(aq, w1, b1, w2, b2)
        else:  # the round trip's values are exact: no mode rounds them
            y = mlp_fused_q8(dequantize(aq).contiguous(), w1, b1, w2, b2)
    else:
        y = mlp_fused_q8(x2.contiguous(), w1, b1, w2, b2, mode)
    return y.reshape(*lead, w2.shape[0])


def mlp_silu_fuse_supported(w1, w2, b: int | None = None) -> bool:
    """True if (w1, w2) can go through the fused SwiGLU kernel: w1 = [gate;
    up] (2F, E) and w2 = down (E, F), both 2-D Q4_0 QTensors, at most
    _MAX_FUSED_B rows. The alignment conditions are the JAX package's gate
    (E, 2F multiples of 128, F of 64), kept so that both packages take the
    same route on the same config; the CUDA kernel itself needs less (E and
    F multiples of 32). One clause of that gate is not kept: its limit on
    the size of a weight tile in the TPU's on-chip memory, which no shape
    meets on the card and which turns the route off at Llama-7B's F."""
    if not (isinstance(w1, QTensor) and isinstance(w2, QTensor)):
        return False
    if w1.gtype != GType.Q4_0 or w2.gtype != GType.Q4_0:
        return False
    if len(w1.shape) != 2 or len(w2.shape) != 2:
        return False
    n1, k1 = w1.shape  # (2F, E)
    n2, k2 = w2.shape  # (E, F)
    if n1 != 2 * k2:
        return False
    if k1 % 128 or n1 % 128 or n2 % 128 or k2 % 64:
        return False
    return b is None or b <= _MAX_FUSED_B


def _ff_silu_ref(w_gate_up, w_down, x, quantize_acts: bool = True):
    """Plain version: the gate/up matmul (after the optional activation
    round trip), silu(gate)·up in f32, and the down matmul on that product
    unquantized."""
    F = w_down.shape[1]
    gu = mul_mat_q(w_gate_up, x, quantize_acts=quantize_acts)
    return mul_mat_q(w_down, silu(gu[..., :F]) * gu[..., F:],
                     quantize_acts=False)


def _mlp_scratch_bytes(b: int, E: int, F: int, splits1: int, splits2: int,
                       planes1: int = 3) -> int:
    """Bytes of the multi-row instance's scratch: the gate/up pass's
    activations (``planes1`` planes: 3 for f32 x, 1 for Q8_0), its splits1
    x [b, 2F] f32 sums, then the down pass's three planes and sums of the
    gated product and its partial sums when K = F is split."""
    return _mma_scratch_bytes(b, 2 * F, E, 1, planes1) \
        + splits1 * b * 2 * F * 4 + _mma_scratch_bytes(b, E, F, splits2)


def silu_one_row_smem(E: int, F: int) -> int:
    """Shared-memory bytes of the b = 1 instance's CTA
    (``csrc/mlp_fused_silu_q4.cu`` smem_bytes): x's and the gated
    product's 32-element blocks, 144 bytes each, and 16 bytes (an mbarrier
    and a count) for each of the gated product's chunks of 32 blocks."""
    return (E // 32 + F // 32) * 144 + -(-F // 1024) * 16


def mlp_fused_silu_q4(x, w1: QTensor, w2: QTensor):
    """Launch the kernel. x [B, E] on the card, B <= _MAX_FUSED_B: f32,
    contiguous, or (from ``MMA_MIN_ROWS`` rows on) the Q8_0 activations
    ``quantize_activations(x, Q4_0)``; w1 [2F, E], w2 [E, F] Q4_0 -> y f32
    [B, E]. One row launches the b = 1 instance, more the multi-row one."""
    q8 = isinstance(x, QTensor)
    lead = x["qs"] if q8 else x
    if not mlp_silu_fuse_supported(w1, w2, lead.shape[0]):
        raise ValueError(f"mlp_fused_silu_q4: unsupported pair {w1!r}, "
                         f"{w2!r} or rows {lead.shape[0]}")
    B, E = lead.shape
    n2, F = w2.shape
    tensors = (lead, w1["qs"], w1["d"], w2["qs"], w2["d"])
    if not lead.is_cuda or any(t.device != lead.device for t in tensors):
        raise ValueError("mlp_fused_silu_q4: all inputs must be on one CUDA "
                         "device")
    if E != w1.shape[1] or n2 != E or not lead.is_contiguous() or (
            lead.dtype != torch.int8 if q8 else lead.dtype != torch.float32):
        raise ValueError(f"mlp_fused_silu_q4: x {tuple(lead.shape)} "
                         f"{lead.dtype} for {w1.shape}, {w2.shape}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp_fused_silu_q4: weights must be contiguous")
    if lead.data_ptr() % (4 if q8 else 16) or w1["qs"].data_ptr() % 16 \
            or w2["qs"].data_ptr() % 16:
        raise ValueError("mlp_fused_silu_q4: misaligned input")
    y = torch.empty((B, E), dtype=torch.float32, device=lead.device)
    if B >= MMA_MIN_ROWS:
        return _launch_silu_mma(x, w1, w2, y)
    if q8:
        raise ValueError("mlp_fused_silu_q4: Q8_0 activations take "
                         f"{MMA_MIN_ROWS} or more rows")
    if silu_one_row_smem(E, F) > _SMEM_MAX or 2 * F * (E // 2) >= 2 ** 31:
        raise ValueError(f"mlp_fused_silu_q4: E {E}, F {F} exceed a CTA's "
                         f"shared memory or 32-bit row offsets at one row")
    a = torch.empty(F // 32 * 36, dtype=torch.float32, device=x.device)
    fn = _build.entry("mlp_fused_silu_q4")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        sync = sync_buffer(x.device, stream)
        rc = fn(x.data_ptr(), w1["qs"].data_ptr(), w1["d"].data_ptr(),
                w2["qs"].data_ptr(), w2["d"].data_ptr(), a.data_ptr(),
                y.data_ptr(), B, E, F, sync.data_ptr(), stream)
    _build.check("mlp_fused_silu_q4", rc)
    return y


def _launch_silu_mma(x, w1: QTensor, w2: QTensor, y):
    """The multi-row instance, operands checked by the caller; x f32 or a
    Q8_0 QTensor of activations (scales f16 [B, E/32])."""
    name = "mlp_fused_silu_q4_mma"
    q8 = isinstance(x, QTensor)
    lead = x["qs"] if q8 else x
    B, E = lead.shape
    F = w2.shape[1]
    if q8:
        xd = x["d"]
        if x.gtype != GType.Q8_0 or xd.dtype != torch.float16 \
                or tuple(xd.shape) != (B, E // 32) or not xd.is_contiguous() \
                or xd.device != lead.device or xd.data_ptr() % 2:
            raise ValueError(f"{name}: Q8 scales {tuple(xd.shape)} "
                             f"{xd.dtype} of {x.gtype.name} do not fit")
    fn = _build.entry(name)
    sms = device_sms(lead.device)
    s1, s2 = mma_splits(2 * F, E, sms), mma_splits(E, F, sms)
    scratch = torch.empty(_mlp_scratch_bytes(B, E, F, s1, s2, 1 if q8 else 3),
                          dtype=torch.uint8, device=lead.device)
    acts = (None, lead.data_ptr(), xd.data_ptr()) if q8 \
        else (x.data_ptr(), None, None)
    with torch.cuda.device(lead.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*acts, w1["qs"].data_ptr(), w1["d"].data_ptr(),
                w2["qs"].data_ptr(), w2["d"].data_ptr(), y.data_ptr(),
                scratch.data_ptr(), B, E, F, s1, s2, stream)
    _build.check(name, rc)
    return y


def flash_ff_silu_q4(w_gate_up: QTensor, w_down: QTensor, x,
                     quantize_acts: bool = True):
    """Apply the fused SwiGLU MLP to x [..., E] -> f32 [..., E]. With
    quantize_acts, one row is handed its dequantized Q8_0 round trip, more
    rows the Q8_0 values and scales themselves."""
    if not use_kernel(x):
        return _ff_silu_ref(w_gate_up, w_down, x, quantize_acts)
    E = w_gate_up.shape[1]
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, E)
    if quantize_acts:
        aq = quantize_activations(x2, GType.Q4_0)
        acts = aq if x2.shape[0] >= MMA_MIN_ROWS \
            else dequantize(aq).contiguous()
    else:
        acts = x2.contiguous()
    y = mlp_fused_silu_q4(acts, w_gate_up, w_down)
    return y.reshape(*lead, w_down.shape[0])
