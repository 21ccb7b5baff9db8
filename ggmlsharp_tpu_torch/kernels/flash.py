"""Cached causal flash attention: the CUDA kernel ``csrc/flash_attn.cu`` and
its wrapper (port of ggmlsharp_tpu/kernels/flash.py::flash_attention_cached).

The plain version is ``_cached_ref`` (flash.py:199-216): dense f32 scores,
the causal mask ``kpos <= npast + s``, softmax, P.V. The wrapper runs it for
a CPU tensor, and for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..ops.attention import NEG_INF
from . import _build


def _cached_ref(q, k, v, npast, scale):
    """Dense f32 cached causal GQA attention. q [B, Hq, S, D], k/v
    [B, Hkv, T, D], npast int [B] -> f32 [B, Hq, S, D]."""
    B, Hq, S, D = q.shape
    Hkv, t = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    qg = q.to(torch.float32).reshape(B, Hkv, n_rep, S, D)
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.to(torch.float32)) * scale
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)
    qpos = npast.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=q.device)[None, :]
    mask = kpos[None, None, None, None, :] <= qpos[:, None, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrst,bgtd->bgrsd", p, v.to(torch.float32))
    return out.reshape(B, Hq, S, D)


def _check_kv(k, v, q):
    """k and v: one dtype, one layout, rows of a head contiguous, batch
    stride Hkv * head stride (a prefix view along T of a longer cache)."""
    B, Hkv, T, D = k.shape
    if v.shape != k.shape or v.dtype != k.dtype or v.stride() != k.stride():
        raise ValueError("flash: k and v must match in shape, dtype and layout")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash: k/v dtype {k.dtype}")
    st = k.stride()
    if st[3] != 1 or st[2] != D or st[0] != Hkv * st[1] or st[1] < T * D:
        raise ValueError(f"flash: unsupported k/v strides {st}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash: q, k and v must be on one device")
    return st[1]


def flash_attention_cached(q, k, v, npast, scale: float | None = None):
    """q [B, Hq, S, D] (new tokens), k/v [B, Hkv, T, D] (the cache prefix,
    f32 or bf16, Hq = Hkv * n_rep), npast int [B] (tokens already cached:
    query s sits at position npast[b] + s) -> f32 [B, Hq, S, D]."""
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _cached_ref(q, k, v, npast, sc)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if D not in (64, 128) or Hq % Hkv or k.shape[0] != B:
        raise ValueError(f"flash: q {tuple(q.shape)} k {tuple(k.shape)}")
    head_stride = _check_kv(k, v, q)
    q32 = q.to(torch.float32).contiguous()
    np32 = npast.to(device=q.device, dtype=torch.int32).contiguous()
    if np32.shape != (B,):
        raise ValueError(f"flash: npast shape {tuple(np32.shape)}")
    out = torch.empty((B, Hq, S, D), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q32.data_ptr(), k.data_ptr(), v.data_ptr(), np32.data_ptr(),
                out.data_ptr(), B, Hq, Hkv, S, T, D, head_stride,
                int(k.dtype == torch.bfloat16), float(sc), stream)
    _build.check("flash_attn", rc)
    return out
