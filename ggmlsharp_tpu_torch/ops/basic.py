"""Elementwise, reduction, normalisation and layout ops (port of
ggmlsharp_tpu/ops/basic.py). Layout mapping as in the JAX package: ggml's
ne[0] (the row) is the last tensor axis."""
from __future__ import annotations

import torch

NORM_EPS_DEFAULT = 1e-5
RMS_NORM_EPS_DEFAULT = 1e-6
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_COEF = 0.044715


# --- binary (same shape: ggml has no implicit broadcasting; use repeat) ---

def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def mul(a, b):
    return a * b


def div(a, b):
    return a / b


# --- unary ----------------------------------------------------------------

def dup(a):
    return a


def sqr(a):
    return a * a


def sqrt(a):
    return torch.sqrt(a)


def abs_(a):
    return torch.abs(a)


def sgn(a):
    return torch.sign(a)


def neg(a):
    return -a


def step(a):
    """1 where a > 0, else 0 (ggml_vec_step)."""
    return (a > 0).to(a.dtype)


def relu(a):
    return torch.clamp(a, min=0)


def gelu(a):
    """ggml's tanh-form GELU."""
    return 0.5 * a * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                       * (a + _GELU_COEF * a * a * a)))


def silu(a):
    return a * torch.sigmoid(a)


# --- reductions -----------------------------------------------------------

def sum_(a):
    """ggml_sum: reduce to a 1-element tensor."""
    return torch.sum(a).reshape(1)


def mean(a):
    """ggml_mean: mean over rows (ne0 -> 1)."""
    return torch.mean(a, dim=-1, keepdim=True)


def max_(a):
    return torch.amax(a).reshape(1)


# --- broadcast ------------------------------------------------------------

def repeat(a, target_shape):
    """ggml_repeat: tile ``a`` up to ``target_shape`` (every target dim a
    multiple of a's)."""
    tshape = tuple(target_shape)
    if tuple(a.shape) == tshape:
        return a
    ashape = (1,) * (len(tshape) - a.dim()) + tuple(a.shape)
    if len(ashape) != len(tshape) or any(t % s for t, s in zip(tshape, ashape)):
        raise ValueError(f"repeat: {tuple(a.shape)} does not tile {tshape}")
    return a.reshape(ashape).repeat(*(t // s for t, s in zip(tshape, ashape)))


def repeat_back(a, target_shape):
    """The VJP of repeat: fold the tiles back down by summation."""
    tshape = tuple(target_shape)
    if tuple(a.shape) == tshape:
        return a
    full = (1,) * (a.dim() - len(tshape)) + tshape
    for ax, (t, s) in enumerate(zip(tuple(a.shape), full)):
        if t != s:
            a = a.reshape(a.shape[:ax] + (t // s, s) + a.shape[ax + 1:]) \
                .sum(dim=ax)
    return a.reshape(tshape)


# --- normalisation --------------------------------------------------------

def norm(a, eps: float = NORM_EPS_DEFAULT):
    """Per-row zero mean and unit variance, no affine."""
    xc = a - torch.mean(a, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def rms_norm(a, eps: float = RMS_NORM_EPS_DEFAULT):
    """Per-row RMS normalisation, no affine."""
    ms = torch.mean(a * a, dim=-1, keepdim=True)
    return a * torch.rsqrt(ms + eps)


# --- misc -----------------------------------------------------------------

def scale(a, s):
    """ggml_scale: multiply by a 1-element tensor."""
    return a * s.reshape(())


def cpy(a, dtype):
    """ggml_cpy's cast half: copy into a destination dtype."""
    return a.to(dtype)


def cont(a):
    """ggml_cont: a contiguous copy where ``a`` is a strided view."""
    return a.contiguous()


def transpose(a):
    """ggml_transpose: swap ne[0] and ne[1], the last two axes."""
    return a.transpose(-1, -2)


def reshape(a, shape):
    return a.reshape(tuple(shape))


def permute(a, axes):
    return a.permute(*axes)


def view(a, shape, offset_elems: int = 0):
    """ggml_view_*: a window of ``shape`` into the flat buffer, starting at
    ``offset_elems``."""
    n = 1
    for s in shape:
        n *= s
    return a.reshape(-1)[offset_elems:offset_elems + n].reshape(tuple(shape))


def map_unary(a, fn):
    """GGML_OP_MAP_UNARY: a user function over the tensor."""
    return fn(a)


def map_binary(a, b, fn):
    return fn(a, b)
