"""Fused MLPs, one launch each: the GELU MLP over a Q8_0 weight pair (CUDA
kernel ``csrc/mlp_fused_q8.cu``, port of
ggmlsharp_tpu/kernels/mlp_fused.py::flash_ff_q8) and the SwiGLU MLP over a
Q4_0 pair (``csrc/mlp_fused_silu_q4.cu``, port of ::flash_ff_silu_q4).

``y = gelu(x·W1ᵀ + b1)·W2ᵀ + b2`` in one launch. The input gets the same
optional Q8_0 activation round trip as an unfused matmul, in plain PyTorch
before the kernel; the intermediate h stays f32 and is never re-quantized.
Both weights are read in the block's one Q8_0 copy (``qs`` int8 [N, K],
``d`` f16 [N, K/32]): the JAX package's permuted, packed planes exist for the
TPU's vector units only.

``flash_ff_silu_q4``: ``y = (silu(x·Wgᵀ) ⊙ (x·Wuᵀ))·Wdᵀ`` with
``w_gate_up = [Wg; Wu]`` (2F, E) and ``w_down`` (E, F), both Q4_0, read in
the block's one copy (the JAX planes are row permutations of the same
payload, which the gated product makes invisible). The input gets the
optional activation round trip outside the kernel; the gate and up rows and
the gated product stay f32 and are never re-quantized, unlike the unfused
route, whose ``w_down`` matmul quantizes its input.

The plain versions are ``_ff_ref`` and ``_ff_silu_ref``. A wrapper runs its
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
from . import _build
from .config import use_kernel

_MAX_FUSED_B = 64  # h is a [rows, n1] f32 scratch; prefill beyond it is unfused


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


def _ff_ref(w1, b1, w2, b2, x, quantize_acts: bool = True):
    """Plain version: two dequantized f32 matmuls around the GELU; h is not
    re-quantized."""
    h = gelu(mul_mat_q(w1, x, quantize_acts=quantize_acts) + b1)
    return mul_mat_q(w2, h, quantize_acts=False) + b2


def _bias_pair(b1, b2):
    """Both biases in one dtype the kernel reads (f32 or bf16)."""
    if b1.dtype == b2.dtype and b1.dtype in (torch.float32, torch.bfloat16):
        return b1.contiguous(), b2.contiguous()
    return b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()


def mlp_fused_q8(x, w1: QTensor, b1, w2: QTensor, b2):
    """Launch the kernel. x f32 [B, k1] contiguous on the card, B <=
    _MAX_FUSED_B -> y f32 [B, n2]."""
    if not mlp_fuse_supported(w1, w2, x.shape[0]):
        raise ValueError(f"mlp_fused_q8: unsupported pair {w1!r}, {w2!r} "
                         f"or rows {x.shape[0]}")
    B, k1 = x.shape
    n1, n2 = w1.shape[0], w2.shape[0]
    tensors = (x, w1["qs"], w1["d"], b1, w2["qs"], w2["d"], b2)
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError("mlp_fused_q8: all inputs must be on one CUDA device")
    if x.dtype != torch.float32 or k1 != w1.shape[1] or not x.is_contiguous():
        raise ValueError(f"mlp_fused_q8: x {tuple(x.shape)} {x.dtype}")
    if tuple(b1.shape) != (n1,) or tuple(b2.shape) != (n2,):
        raise ValueError("mlp_fused_q8: bias shapes")
    if not all(w[p].is_contiguous() for w in (w1, w2) for p in ("qs", "d")):
        raise ValueError("mlp_fused_q8: weights must be contiguous")
    if x.data_ptr() % 16 or w1["qs"].data_ptr() % 16 \
            or w2["qs"].data_ptr() % 16:
        raise ValueError("mlp_fused_q8: misaligned input")
    b1, b2 = _bias_pair(b1, b2)
    h = torch.empty((B, n1), dtype=torch.float32, device=x.device)
    y = torch.empty((B, n2), dtype=torch.float32, device=x.device)
    fn = _build.entry("mlp_fused_q8")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w1["qs"].data_ptr(), w1["d"].data_ptr(),
                b1.data_ptr(), w2["qs"].data_ptr(), w2["d"].data_ptr(),
                b2.data_ptr(), h.data_ptr(), y.data_ptr(), B, k1, n1, n2,
                int(b1.dtype == torch.bfloat16), stream)
    _build.check("mlp_fused_q8", rc)
    return y


def flash_ff_q8(w1: QTensor, b1, w2: QTensor, b2, x,
                quantize_acts: bool = True):
    """Apply the fused MLP to x [..., k1] -> f32 [..., n2]."""
    if not use_kernel(x):
        return _ff_ref(w1, b1, w2, b2, x, quantize_acts)
    k1 = w1.shape[1]
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, k1)
    if quantize_acts:
        x2 = dequantize(quantize_activations(x2, GType.Q8_0))
    y = mlp_fused_q8(x2.contiguous(), w1, b1, w2, b2)
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


def mlp_fused_silu_q4(x, w1: QTensor, w2: QTensor):
    """Launch the kernel. x f32 [B, E] contiguous on the card, B <=
    _MAX_FUSED_B; w1 [2F, E], w2 [E, F] Q4_0 -> y f32 [B, E]."""
    if not mlp_silu_fuse_supported(w1, w2, x.shape[0]):
        raise ValueError(f"mlp_fused_silu_q4: unsupported pair {w1!r}, "
                         f"{w2!r} or rows {x.shape[0]}")
    B, E = x.shape
    n2, F = w2.shape
    tensors = (x, w1["qs"], w1["d"], w2["qs"], w2["d"])
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError("mlp_fused_silu_q4: all inputs must be on one CUDA "
                         "device")
    if x.dtype != torch.float32 or E != w1.shape[1] or n2 != E \
            or not x.is_contiguous():
        raise ValueError(f"mlp_fused_silu_q4: x {tuple(x.shape)} {x.dtype} "
                         f"for {w1.shape}, {w2.shape}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp_fused_silu_q4: weights must be contiguous")
    if x.data_ptr() % 16 or w1["qs"].data_ptr() % 16 \
            or w2["qs"].data_ptr() % 16:
        raise ValueError("mlp_fused_silu_q4: misaligned input")
    a = torch.empty((B, F), dtype=torch.float32, device=x.device)
    y = torch.empty((B, E), dtype=torch.float32, device=x.device)
    fn = _build.entry("mlp_fused_silu_q4")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w1["qs"].data_ptr(), w1["d"].data_ptr(),
                w2["qs"].data_ptr(), w2["d"].data_ptr(), a.data_ptr(),
                y.data_ptr(), B, E, F, stream)
    _build.check("mlp_fused_silu_q4", rc)
    return y


def flash_ff_silu_q4(w_gate_up: QTensor, w_down: QTensor, x,
                     quantize_acts: bool = True):
    """Apply the fused SwiGLU MLP to x [..., E] -> f32 [..., E]."""
    if not use_kernel(x):
        return _ff_silu_ref(w_gate_up, w_down, x, quantize_acts)
    E = w_gate_up.shape[1]
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, E)
    if quantize_acts:
        x2 = dequantize(quantize_activations(x2, GType.Q4_0))
    y = mlp_fused_silu_q4(x2.contiguous(), w_gate_up, w_down)
    return y.reshape(*lead, w_down.shape[0])
