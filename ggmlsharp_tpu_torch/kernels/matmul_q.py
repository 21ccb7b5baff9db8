"""Q4_0 dequant-matmul: the CUDA kernel ``csrc/matmul_q4_0.cu`` and its wrapper.

Port of ggmlsharp_tpu/kernels/matmul_q.py (``mul_mat_q_fused`` ->
``_call_kernel_swar``) for Q4_0. As in the JAX package, the ggml activation
round trip through Q8_0 runs in plain PyTorch before the kernel; the kernel
computes ``y[b, n] = sum_k x[b, k] * d[n, k/32] * (q[n, k] - 8)`` in f32.
The plain version is ``ops.matmul.mul_mat_q`` (dequantize, then an f32
matmul): the wrapper runs it for a CPU tensor, and for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..dtypes import GType
from ..quant.formats import QTensor
from ..quant.quantize import dequantize
from . import _build


def q4_0_matmul(x, qs, d):
    """Launch the kernel. x f32 [B, K]; qs uint8 [N, K/2]; d f16 [N, K/32]
    (all contiguous, on one card) -> y f32 [B, N]."""
    B, K = x.shape
    N = qs.shape[0]
    if not (x.is_cuda and qs.device == x.device and d.device == x.device):
        raise ValueError("q4_0_matmul: x, qs and d must be on one CUDA device")
    if x.dtype != torch.float32 or qs.dtype != torch.uint8 \
            or d.dtype != torch.float16:
        raise TypeError(f"q4_0_matmul: got {x.dtype}, {qs.dtype}, {d.dtype}")
    if K % 32 or tuple(qs.shape) != (N, K // 2) \
            or tuple(d.shape) != (N, K // 32):
        raise ValueError(f"q4_0_matmul: shapes x {tuple(x.shape)}, "
                         f"qs {tuple(qs.shape)}, d {tuple(d.shape)}")
    if not (x.is_contiguous() and qs.is_contiguous() and d.is_contiguous()):
        raise ValueError("q4_0_matmul: inputs must be contiguous")
    if x.data_ptr() % 16 or qs.data_ptr() % 16 or d.data_ptr() % 2:
        raise ValueError("q4_0_matmul: misaligned input")
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    fn = _build.entry("matmul_q4_0")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), qs.data_ptr(), d.data_ptr(), y.data_ptr(),
                B, N, K, stream)
    _build.check("matmul_q4_0", rc)
    return y


def mul_mat_q_fused(a: QTensor, bx, quantize_acts: bool = True):
    """Quantized mul_mat: a [n, k] QTensor, bx [..., k] -> f32 [..., n]."""
    if not bx.is_cuda:
        from ..ops.matmul import mul_mat_q

        return mul_mat_q(a, bx, quantize_acts=quantize_acts)
    if a.gtype != GType.Q4_0:
        raise NotImplementedError(f"no CUDA kernel for {a.gtype.name} yet")
    n, k = a.shape
    x = bx.to(torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if quantize_acts:
        from ..ops.matmul import quantize_activations

        x2 = dequantize(quantize_activations(x2, a.gtype))
    return q4_0_matmul(x2.contiguous(), a["qs"], a["d"]).reshape(*lead, n)
