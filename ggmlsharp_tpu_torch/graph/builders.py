"""Op builders: the graph-construction surface, ggml_add ... ggml_flash_attn
(port of ggmlsharp_tpu/graph/builders.py). Each builder wraps a function of
``ggmlsharp_tpu_torch.ops`` into a GTensor node; shape errors surface when
the node is built (meta-device shape inference in GTensor.__init__).
A constant operand becomes a leaf on the device of the node's first graph
operand."""
from __future__ import annotations

import torch

from .. import ops as O
from ..quant.formats import QTensor
from .core import GTensor, leaf


def as_node(x, device=None):
    return x if isinstance(x, GTensor) else leaf(x, device=device)


def _node(op, fwd, *srcs, name=None, **kwargs):
    dev = next((s.device for s in srcs
                if isinstance(s, GTensor) and s.device is not None), None)
    return GTensor(op, srcs=[as_node(s, dev) for s in srcs], kwargs=kwargs,
                   fwd=fwd, name=name)


# --- binary ---------------------------------------------------------------

def add(a, b):
    return _node("add", O.add, a, b)


def sub(a, b):
    return _node("sub", O.sub, a, b)


def mul(a, b):
    return _node("mul", O.mul, a, b)


def div(a, b):
    return _node("div", O.div, a, b)


# --- unary ----------------------------------------------------------------

def dup(a):
    return _node("dup", O.dup, a)


def sqr(a):
    return _node("sqr", O.sqr, a)


def sqrt(a):
    return _node("sqrt", O.sqrt, a)


def abs_(a):
    return _node("abs", O.abs_, a)


def sgn(a):
    return _node("sgn", O.sgn, a)


def neg(a):
    return _node("neg", O.neg, a)


def step(a):
    return _node("step", O.step, a)


def relu(a):
    return _node("relu", O.relu, a)


def gelu(a):
    return _node("gelu", O.gelu, a)


def silu(a):
    return _node("silu", O.silu, a)


# --- reductions / broadcast ----------------------------------------------

def sum(a):  # noqa: A001 - ggml name
    return _node("sum", O.sum_, a)


def mean(a):
    return _node("mean", O.mean, a)


def repeat(a, shape):
    return _node("repeat", O.repeat, a, target_shape=tuple(shape))


def repeat_back(a, shape):
    return _node("repeat_back", O.repeat_back, a, target_shape=tuple(shape))


# --- normalisation --------------------------------------------------------

def norm(a, eps: float = 1e-5):
    return _node("norm", O.norm, a, eps=eps)


def rms_norm(a, eps: float = 1e-6):
    return _node("rms_norm", O.rms_norm, a, eps=eps)


# --- matmul ---------------------------------------------------------------

def mul_mat(a, b):
    """ggml_mul_mat: a [n_out, k] (float or QTensor leaf), b [..., k]."""
    return _node("mul_mat", O.mul_mat, a, b)


def _mat_tb(gv, bv):
    gn = gv.reshape(-1, gv.shape[-1]).to(torch.float32)
    bn = bv.reshape(-1, bv.shape[-1]).to(torch.float32)
    return torch.matmul(gn.T, bn)


def mat_tb(g, b):
    """Σ over the batch of g ⊗ b: [..., n] x [..., k] -> [n, k] f32 (the
    mul_mat VJP in its weight)."""
    return _node("mat_tb", _mat_tb, g, b)


def _mat_nn(gv, av):
    if isinstance(av, QTensor):
        from ..quant.quantize import dequantize

        av = dequantize(av)
    return torch.matmul(gv.to(torch.float32), av.to(torch.float32))


def mat_nn(g, a):
    """g [..., n] @ a [n, k] -> [..., k] f32 (the mul_mat VJP in its
    activations)."""
    return _node("mat_nn", _mat_nn, g, a)


def out_prod(a, b):
    return _node("out_prod", O.out_prod, a, b)


# --- misc -----------------------------------------------------------------

def scale(a, s):
    return _node("scale", O.scale, a, s)


def _scale_const(v, c):
    return v * c


def scale_const(a, c: float):
    return _node("scale_const", _scale_const, a, c=float(c))


def cpy(a, dtype):
    return _node("cpy", O.cpy, a, dtype=dtype)


def cont(a):
    return _node("cont", O.cont, a)


def transpose(a):
    return _node("transpose", O.transpose, a)


def reshape(a, shape):
    return _node("reshape", O.reshape, a, shape=tuple(shape))


def permute(a, axes):
    return _node("permute", O.permute, a, axes=tuple(axes))


def view(a, shape, offset_elems: int = 0):
    return _node("view", O.view, a, shape=tuple(shape),
                 offset_elems=offset_elems)


def map_unary(a, fn):
    return _node("map_unary", O.map_unary, a, fn=fn)


def map_binary(a, b, fn):
    return _node("map_binary", O.map_binary, a, b, fn=fn)


# --- the transformer set (ops the reference declares but stubs) -----------

def get_rows(table, ids):
    return _node("get_rows", O.get_rows, table, ids)


def diag_mask_inf(a, n_past: int = 0):
    return _node("diag_mask_inf", O.diag_mask_inf, a, n_past=n_past)


def soft_max(a):
    return _node("soft_max", O.soft_max, a)


def rope(a, n_past: int, n_dims: int | None = None, mode: int = 0):
    return _node("rope", O.rope_n_past, a, n_past=n_past, n_dims=n_dims,
                 mode=mode)


def alibi(a, n_past: int, n_head: int):
    return _node("alibi", O.alibi, a, n_past=n_past, n_head=n_head)


def conv_1d_1s(x, w):
    return _node("conv_1d_1s", O.conv_1d_1s, x, w)


def conv_1d_2s(x, w):
    return _node("conv_1d_2s", O.conv_1d_2s, x, w)


def _flash_attn(qv, kv, vv, masked, plain):
    return O.flash_attn(qv, kv, vv, masked=masked, plain=plain)


def flash_attn(q, k, v, masked: bool = True, plain: bool = False):
    """The flash kernel on CUDA tensors (differentiable: its backward
    recomputes the dense version), the materialised-scores op on CPU
    tensors or with ``plain=True``."""
    return _node("flash_attn", _flash_attn, q, k, v, masked=masked,
                 plain=plain)


def flash_ff(x, w0, b0, w1, b1):
    return _node("flash_ff", O.flash_ff, x, w0, b0, w1, b1)
