"""Fused GELU MLP over a Q8_0 weight pair: the CUDA kernel
``csrc/mlp_fused_q8.cu`` and its wrapper (port of
ggmlsharp_tpu/kernels/mlp_fused.py::flash_ff_q8).

``y = gelu(x·W1ᵀ + b1)·W2ᵀ + b2`` in one launch. The input gets the same
optional Q8_0 activation round trip as an unfused matmul, in plain PyTorch
before the kernel; the intermediate h stays f32 and is never re-quantized.
Both weights are read in the block's one Q8_0 copy (``qs`` int8 [N, K],
``d`` f16 [N, K/32]): the JAX package's permuted, packed planes exist for the
TPU's vector units only.

The plain version is ``_ff_ref``. The wrapper runs it for a CPU tensor; for
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..dtypes import GType
from ..ops.basic import gelu
from ..ops.matmul import mul_mat_q, quantize_activations
from ..quant.formats import QTensor
from ..quant.quantize import dequantize
from . import _build

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
    if not x.is_cuda:
        return _ff_ref(w1, b1, w2, b2, x, quantize_acts)
    k1 = w1.shape[1]
    lead = x.shape[:-1]
    x2 = x.to(torch.float32).reshape(-1, k1)
    if quantize_acts:
        x2 = dequantize(quantize_activations(x2, GType.Q8_0))
    y = mlp_fused_q8(x2.contiguous(), w1, b1, w2, b2)
    return y.reshape(*lead, w2.shape[0])
