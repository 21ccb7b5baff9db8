"""Rotary position embedding (port of ggmlsharp_tpu/ops/attention.py:38-72)."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite sentinel: a fully masked softmax row stays NaN-free


def rope(a, positions, mode: int = 0, base: float = 10000.0):
    """a: [..., S, D]; positions: int [S] or [B, S] absolute positions
    (a [B, S] tensor broadcasts over the head axis of a [B, H, S, D] input).
    mode 0: interleaved pairs (2i, 2i+1), ggml's legacy rope.
    mode 2: NeoX halves (i, i + D/2)."""
    nd = a.shape[-1]
    half = nd // 2
    pos = positions.to(torch.float32)[..., :, None]  # [..., S, 1]
    if pos.dim() == 3:  # [B, S, 1] -> [B, 1, S, 1] over heads
        pos = pos[:, None]
    exps = -torch.arange(half, dtype=torch.float32, device=a.device) * 2.0 / nd
    inv_freq = torch.pow(float(base), exps)  # a scalar base: no host copy
    theta = pos * inv_freq
    cos, sin = torch.cos(theta), torch.sin(theta)

    rot = a.to(torch.float32)
    if mode & 2:
        x1, x2 = rot[..., :half], rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(rot.shape)
    return out.to(a.dtype)
