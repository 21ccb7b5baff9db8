"""Matrix multiply, float and quantized (port of ggmlsharp_tpu/ops/matmul.py).

ggml convention: ``mul_mat(a, b)`` dots rows of ``a`` (weights [n_out, k])
with rows of ``b`` (activations [..., k]) -> [..., n_out], i.e. ``b @ a.T``.

Quantized semantics: activations are first rounded through the weight
format's ``vec_dot_type`` (Q8_0, Q8_1 or Q8_K), then the dot of the two
dequantized operands is taken in f32, the k-quant weights with their fused
f16 sub-block scales (``dequantize(..., fused_scales=True)``, the scales the
JAX package's matmul kernels read). ``mul_mat_q`` is that function in plain
PyTorch; ``mul_mat`` sends a CUDA tensor to the hand-written kernel of the
weight's format (``kernels.matmul_q``: every block format a weight takes)
and a CPU tensor to its plain version.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..dtypes import TYPE_TRAITS, GType
from ..quant.formats import QTensor
from ..quant.quantize import dequantize, quantize


_HALF = (torch.bfloat16, torch.float16)


class _HalfProduct(torch.autograd.Function):
    """b2 [m, k] · aᵀ [k, n] -> f32 [m, n] for two bf16 (or two f16)
    operands on the card: cuBLAS on the tensor cores in the operands' dtype
    with an f32 output (``aten::mm.dtype``), so each product accumulates
    in f32 and is rounded once by the caller, whatever
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    says (that flag lets a bf16 output's split-K partials be summed in
    bf16; an f32 output never is). The backward's two products take the
    same route."""

    @staticmethod
    def forward(ctx, a, b2):
        ctx.save_for_backward(a, b2)
        return torch.mm(b2, a.t(), out_dtype=torch.float32)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b2 = ctx.saved_tensors
        g = g.to(a.dtype)  # the gradient of a rounded output: exact
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g.t(), b2, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(g, a, out_dtype=torch.float32).to(b2.dtype)
        return ga, gb


def mul_mat_f(a, b):
    """Float mul_mat: a [n_out, k], b [..., k] -> [..., n_out], f32
    accumulation, result in the promoted type of a and b (JAX: a matmul in
    the operands' dtype with an f32 accumulator). Two bf16 (or two f16)
    operands with a 2-D ``a`` on the card multiply on the tensor cores
    (``_HalfProduct``); elsewhere both are widened to f32, which computes
    the same function (a product of two 16-bit floats is exact in f32)."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if a.is_cuda and a.dtype == b.dtype and a.dtype in _HALF \
            and a.dim() == 2:
        y = _HalfProduct.apply(a, b.reshape(-1, b.shape[-1]))
        return y.reshape(*b.shape[:-1], a.shape[0]).to(out_dtype)
    return torch.matmul(b.to(torch.float32),
                        a.to(torch.float32).transpose(-1, -2)).to(out_dtype)


def quantize_activations(b, weight_gtype: GType) -> QTensor:
    """Quantize activation rows to the weight format's companion dot type
    (ggml's mul_mat INIT phase)."""
    return quantize(b, TYPE_TRAITS[GType(weight_gtype)].vec_dot_type)


def round_bf16(x):
    """x rounded to bf16 (to nearest even), back in f32: the activation
    operand of mm_dot "bf16" (kernels.config)."""
    return x.to(torch.bfloat16).to(torch.float32)


def mul_mat_q(a: QTensor, b, quantize_acts: bool = True, mode: str = "f32"):
    """Quantized mul_mat, plain version: dequantize, then an f32 matmul.
    a: QTensor [n_out, k]; b: float activations [..., k] -> f32 [..., n_out].
    mode: the ``mm_dot`` function; "bf16" rounds float activations to bf16
    first (the Q8 round trip's values are exact either way and are not
    rounded). The matmul dispatch (``kernels.matmul_q.mul_mat_q_fused``)
    passes the configured mode; callers inside other kernels' plain
    versions keep "f32"."""
    if mode not in ("f32", "bf16"):
        raise ValueError(f"mul_mat_q: mm_dot mode {mode!r}")
    w = dequantize(a, fused_scales=True)
    if quantize_acts:
        b = dequantize(quantize_activations(b, a.gtype))
    elif mode == "bf16":
        b = round_bf16(b.to(torch.float32))
    return torch.matmul(b.to(torch.float32), w.transpose(-1, -2))


def mul_mat(a, b, quantize_acts: bool = True, plain: bool = False):
    """Dispatch on the weight type: QTensor weights go to the quantized
    matmul (kernel on the card, plain version on the CPU or with
    plain=True)."""
    if isinstance(a, QTensor):
        from ..kernels.matmul_q import mul_mat_q_fused

        return mul_mat_q_fused(a, b, quantize_acts=quantize_acts,
                               plain=plain)
    return mul_mat_f(a, b)


def out_prod(a, b):
    """Outer product: a [m], b [n] -> [n, m], batched over leading dims
    (the operand the full mul_mat VJP needs)."""
    return torch.einsum("...i,...j->...ji", a, b)
