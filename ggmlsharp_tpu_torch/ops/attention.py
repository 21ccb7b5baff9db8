"""Attention-family ops (port of ggmlsharp_tpu/ops/attention.py):
soft_max, diag_mask_inf, rope, alibi, flash_attn and flash_ff.

``flash_attn`` runs the flash kernel's autograd Function
(``kernels.flash.flash_attention``, the uncached entry) for a CUDA tensor
and ``_flash_dense``, the JAX package's CPU route (materialised scores), for
a CPU tensor or with ``plain=True``.
"""
from __future__ import annotations

import math

import torch

from ..kernels.config import use_kernel

NEG_INF = -1e30  # finite sentinel: a fully masked softmax row stays NaN-free


def soft_max(a, axis: int = -1):
    """ggml_soft_max: numerically stable softmax over rows (the max is
    held constant under differentiation, as the JAX op's stop_gradient)."""
    m = torch.amax(a, dim=axis, keepdim=True).detach()
    e = torch.exp(a - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


def diag_mask_inf(a, n_past: int = 0):
    """ggml_diag_mask_inf: causal mask on score matrices [..., n_q, n_k]:
    position (i, j) is masked when j > n_past + i."""
    n_q, n_k = a.shape[-2], a.shape[-1]
    i = torch.arange(n_q, device=a.device)[:, None]
    j = torch.arange(n_k, device=a.device)[None, :]
    return torch.where(j > i + n_past,
                       torch.tensor(NEG_INF, dtype=a.dtype, device=a.device),
                       a)


def rope(a, positions, n_dims: int | None = None, mode: int = 0,
         base: float = 10000.0):
    """a: [..., S, D]; positions: int [S] or [B, S] absolute positions
    (a [B, S] tensor broadcasts over the head axis of a [B, H, S, D] input).
    n_dims: rotate only the first n_dims features (the rest pass through).
    mode 0: interleaved pairs (2i, 2i+1), ggml's legacy rope.
    mode 2: NeoX halves (i, i + n_dims/2)."""
    d = a.shape[-1]
    nd = d if n_dims is None else n_dims
    half = nd // 2
    pos = positions.to(torch.float32)[..., :, None]  # [..., S, 1]
    if pos.dim() == 3:  # [B, S, 1] -> [B, 1, S, 1] over heads
        pos = pos[:, None]
    exps = -torch.arange(half, dtype=torch.float32, device=a.device) * 2.0 / nd
    inv_freq = torch.pow(float(base), exps)  # a scalar base: no host copy
    theta = pos * inv_freq
    cos, sin = torch.cos(theta), torch.sin(theta)

    rot = a[..., :nd].to(torch.float32)
    if mode & 2:
        x1, x2 = rot[..., :half], rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(rot.shape)
    out = out.to(a.dtype)
    return out if nd == d else torch.cat([out, a[..., nd:]], dim=-1)


def rope_n_past(a, n_past: int, n_dims: int | None = None, mode: int = 0,
                base: float = 10000.0):
    """ggml-style entry point: positions = n_past + arange(seq)."""
    positions = n_past + torch.arange(a.shape[-2], dtype=torch.int32,
                                      device=a.device)
    return rope(a, positions, n_dims=n_dims, mode=mode, base=base)


def alibi_slopes(n_head: int, bias_max: float = 8.0, device=None):
    """ALiBi head slopes: 2^(-bias_max * h / n_head_pow2) with the
    interpolated tail for head counts that are no power of two."""
    n = 2 ** math.floor(math.log2(n_head))
    m0 = 2.0 ** (-bias_max / n)
    slopes = [m0 ** (i + 1) for i in range(n)]
    if n < n_head:
        m1 = 2.0 ** (-bias_max / (2 * n))
        slopes += [m1 ** (2 * i + 1) for i in range(n_head - n)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi(scores, n_past: int, n_head: int, bias_max: float = 8.0):
    """GGML_OP_ALIBI: add the per-head linear position bias to score
    matrices [..., n_head, n_q, n_k]: bias[h, i, j] = slope_h * j."""
    n_k = scores.shape[-1]
    slopes = alibi_slopes(n_head, bias_max, device=scores.device)
    j = torch.arange(n_k, dtype=torch.float32, device=scores.device)
    return scores + (slopes[:, None, None] * j[None, None, :]).to(scores.dtype)


def _flash_dense(q, k, v, masked, sc, n_past):
    """Materialised-scores attention: f32 scores, the mask, soft_max, p in
    v's dtype, f32 P.V, the result in q's dtype."""
    scores = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * sc
    if masked:
        scores = diag_mask_inf(scores, n_past=n_past)
    p = soft_max(scores)
    return torch.matmul(p.to(v.dtype).to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


def flash_attn(q, k, v, masked: bool = True,
               scale_override: float | None = None, n_past: int = 0,
               plain: bool = False):
    """GGML_OP_FLASH_ATTN: softmax(q·kᵀ/√d [+ mask])·v.
    q: [..., n_q, d], k/v: [..., n_k, d] -> [..., n_q, d]. ``masked`` applies
    the causal mask with the n_past offset (diag_mask_inf semantics). A
    CUDA tensor goes through the flash kernel (differentiable: its backward
    recomputes the dense version); a CPU tensor, or ``plain=True``, through
    ``_flash_dense``."""
    sc = scale_override if scale_override is not None \
        else 1.0 / (q.shape[-1] ** 0.5)
    if use_kernel(q, plain):
        from ..kernels.flash import flash_attention

        return flash_attention(q, k, v, causal=bool(masked),
                               n_past=int(n_past), scale=float(sc))
    return _flash_dense(q, k, v, masked, sc, n_past)


def flash_ff(x, w0, b0, w1, b1):
    """GGML_OP_FLASH_FF: the two-layer GELU MLP
    x [..., d_in] -> gelu(x·w0ᵀ + b0)·w1ᵀ + b1."""
    from .basic import gelu
    from .matmul import mul_mat_f

    return mul_mat_f(w1, gelu(mul_mat_f(w0, x) + b0)) + b1
