"""Elementwise and normalisation ops (port of part of ggmlsharp_tpu/ops/basic.py)."""
from __future__ import annotations

import torch

NORM_EPS_DEFAULT = 1e-5
RMS_NORM_EPS_DEFAULT = 1e-6
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_COEF = 0.044715


def silu(a):
    return a * torch.sigmoid(a)


def gelu(a):
    """ggml's tanh-form GELU."""
    return 0.5 * a * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                       * (a + _GELU_COEF * a * a * a)))


def norm(a, eps: float = NORM_EPS_DEFAULT):
    """Per-row zero mean and unit variance, no affine."""
    xc = a - torch.mean(a, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def rms_norm(a, eps: float = RMS_NORM_EPS_DEFAULT):
    """Per-row RMS normalisation, no affine."""
    ms = torch.mean(a * a, dim=-1, keepdim=True)
    return a * torch.rsqrt(ms + eps)
