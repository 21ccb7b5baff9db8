"""Q4_0 and Q8_0 dequant-matmul: the CUDA kernels ``csrc/matmul_q4_0.cu`` and
``csrc/matmul_q8_0.cu`` and their wrappers.

Port of ggmlsharp_tpu/kernels/matmul_q.py (``mul_mat_q_fused`` ->
``_call_kernel_swar`` for Q4_0, ``_call_kernel_swar_q8`` for Q8_0). As in the
JAX package, the ggml activation round trip through Q8_0 runs in plain
PyTorch before the kernel; the kernels compute
``y[b, n] = sum_k x[b, k] * d[n, k/32] * (q[n, k] - 8)`` (Q4_0) and
``y[b, n] = sum_k x[b, k] * d[n, k/32] * q[n, k]`` (Q8_0) in f32.
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


def _launch(name, x, qs, d, qs_dtype, qs_cols):
    """Check the operands of kernel ``name`` and launch it: x f32 [B, K], qs
    ``qs_dtype`` [N, qs_cols], d f16 [N, K/32] (all contiguous, on one card)
    -> y f32 [B, N]."""
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
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    fn = _build.entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), qs.data_ptr(), d.data_ptr(), y.data_ptr(),
                B, N, K, stream)
    _build.check(name, rc)
    return y


def q4_0_matmul(x, qs, d):
    """Launch the Q4_0 kernel. x f32 [B, K]; qs uint8 [N, K/2]; d f16
    [N, K/32] -> y f32 [B, N]."""
    return _launch("matmul_q4_0", x, qs, d, torch.uint8, x.shape[1] // 2)


def q8_0_matmul(x, qs, d):
    """Launch the Q8_0 kernel. x f32 [B, K]; qs int8 [N, K]; d f16
    [N, K/32] -> y f32 [B, N]."""
    return _launch("matmul_q8_0", x, qs, d, torch.int8, x.shape[1])


_KERNELS = {GType.Q4_0: q4_0_matmul, GType.Q8_0: q8_0_matmul}


def mul_mat_q_fused(a: QTensor, bx, quantize_acts: bool = True):
    """Quantized mul_mat: a [n, k] QTensor, bx [..., k] -> f32 [..., n]."""
    if not bx.is_cuda:
        from ..ops.matmul import mul_mat_q

        return mul_mat_q(a, bx, quantize_acts=quantize_acts)
    if a.gtype not in _KERNELS:
        raise NotImplementedError(f"no CUDA kernel for {a.gtype.name} yet")
    n, k = a.shape
    x = bx.to(torch.float32)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if quantize_acts:
        from ..ops.matmul import quantize_activations

        x2 = dequantize(quantize_activations(x2, a.gtype))
    y = _KERNELS[a.gtype](x2.contiguous(), a["qs"], a["d"])
    return y.reshape(*lead, n)
