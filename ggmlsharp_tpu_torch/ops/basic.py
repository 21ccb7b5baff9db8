"""Elementwise and normalisation ops (port of part of ggmlsharp_tpu/ops/basic.py)."""
from __future__ import annotations

import torch

RMS_NORM_EPS_DEFAULT = 1e-6


def silu(a):
    return a * torch.sigmoid(a)


def rms_norm(a, eps: float = RMS_NORM_EPS_DEFAULT):
    """Per-row RMS normalisation, no affine."""
    ms = torch.mean(a * a, dim=-1, keepdim=True)
    return a * torch.rsqrt(ms + eps)
