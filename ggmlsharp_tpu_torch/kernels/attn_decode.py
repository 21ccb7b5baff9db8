"""Batched single-token decode attention over a flat KV cache: the CUDA
kernel ``csrc/attn_decode.cu`` and its wrappers (port of
ggmlsharp_tpu/kernels/attn_decode.py::flash_decode_flat, layout "heads", and
::flash_decode_flat_attn, layout "attn").

Each slot's one query attends the cache rows t < min(npast[b], T) of a
flat [B, T, E_kv] cache (lane j belongs to KV head j // D) plus the fresh
token's unquantized K/V row, which stands in for the stale row npast[b].
The cache is bf16, or int8 with per-(token, head) scales [B, T, H_kv]. The arithmetic is
f32 throughout: the JAX kernel's exact mode (GGML_TPU_MM_DOT=f32); its
default mode rounds the softmax weights to the cache dtype for the MXU,
which the port does not copy.

``flash_decode_flat_attn`` is the same function over rows in the "attn"
lane map of the JAX package's whole-block llama kernel: KV head h owns lanes
[h·D/2, (h+1)·D/2) and the same run at +E_kv/2, and the query and the output
are n_rep consecutive E_kv-wide blocks in that map. The kernel takes the map
as one more argument. The port's own caches stay in element order, so no path
of the port calls it; it is ported so the kernel is whole, and
``chip_smoke.py`` holds it against its plain version and times it.

The plain version is ``_decode_ref``: dequantize, append the fresh row
as key T, mask the cache rows t >= npast, softmax, P.V, all dense f32
(``_decode_ref_attn``: permute to element order, ``_decode_ref``, permute
back). A wrapper runs it for a CPU tensor, and for a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from ..ops.attention import NEG_INF
from . import _build
from .config import use_kernel

_KV_KIND = {torch.bfloat16: 0, torch.int8: 1}


def _dequant(rows, scale, n_head_kv):
    """Flat rows [B, T, E] (and scales [B, T, H] for int8) -> f32."""
    rows = rows.to(torch.float32)
    if scale is None:
        return rows
    B, T, E = rows.shape
    return (rows.reshape(B, T, n_head_kv, E // n_head_kv)
            * scale[..., None]).reshape(B, T, E)


def _decode_ref(q, k_new, v_new, k_cache, v_cache, npast, n_head_kv: int,
                head_dim: int, k_scale=None, v_scale=None):
    """Dense f32 decode attention. q (B, Hq, D) UNscaled; k_new/v_new
    (B, E); k_cache/v_cache (B, T, E); npast int (B,) -> f32 (B, Hq, D).
    The fresh row is key T, always attended; cache row t is attended when
    t < npast[b] (so npast >= T attends all T rows, as the kernel does)."""
    B, Hq, D = q.shape
    T = k_cache.shape[1]
    n_rep = Hq // n_head_kv
    k = torch.cat([_dequant(k_cache, k_scale, n_head_kv),
                   k_new.to(torch.float32)[:, None]], 1)
    v = torch.cat([_dequant(v_cache, v_scale, n_head_kv),
                   v_new.to(torch.float32)[:, None]], 1)
    kh = k.reshape(B, T + 1, n_head_kv, D)
    vh = v.reshape(B, T + 1, n_head_kv, D)
    qg = (q.to(torch.float32) * (1.0 / D ** 0.5)).reshape(B, n_head_kv,
                                                          n_rep, D)
    s = torch.einsum("bgrd,btgd->bgrt", qg, kh)
    t = torch.arange(T + 1, device=q.device)
    npl = npast.to(device=q.device, dtype=torch.long)
    live = (t[None, :] < npl[:, None]) | (t[None, :] == T)
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrt,btgd->bgrd", p, vh).reshape(B, Hq, D)


def _cache_kind(k_cache, v_cache):
    kind = _KV_KIND.get(k_cache.dtype)
    if kind is None or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"attn_decode: cache dtypes {k_cache.dtype}, "
                        f"{v_cache.dtype}: bf16 or int8")
    return kind


def _check(q, k_new, v_new, k_cache, v_cache, npast, n_head_kv, head_dim,
           k_scale, v_scale):
    """q: (B, Hq, D) in either lane map (only its first two dims' product
    and its last dim are looked at)."""
    B, Hq, D = q.shape
    E = n_head_kv * head_dim
    T = k_cache.shape[1]
    if D != head_dim or D not in (64, 128) or Hq % n_head_kv \
            or Hq // n_head_kv > 32:
        raise ValueError(f"attn_decode: q {tuple(q.shape)}, "
                         f"n_head_kv {n_head_kv}, head_dim {head_dim}")
    kind = _cache_kind(k_cache, v_cache)
    if (kind == 1) != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError("attn_decode: int8 caches need k_scale and v_scale, "
                         "float caches none")
    for name, x, shape in (("k_cache", k_cache, (B, T, E)),
                           ("v_cache", v_cache, (B, T, E)),
                           ("k_new", k_new, (B, E)), ("v_new", v_new, (B, E)),
                           ("npast", npast, (B,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"attn_decode: {name} shape {tuple(x.shape)}, "
                             f"want {shape}")
    tensors = [q, k_new, v_new, k_cache, v_cache, npast]
    if k_scale is not None:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(s.shape) != (B, T, n_head_kv) \
                    or s.dtype != torch.float32 or s.stride()[1:] != \
                    (n_head_kv, 1):
                raise ValueError(f"attn_decode: {name} {tuple(s.shape)} "
                                 f"{s.dtype} strides {s.stride()}")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("attn_decode: k_scale and v_scale layouts differ")
        tensors += [k_scale, v_scale]
    if any(x.device != q.device for x in tensors):
        raise ValueError("attn_decode: all inputs must be on one device")
    st = k_cache.stride()
    if st[1:] != (E, 1) or v_cache.stride() != st:
        raise ValueError(f"attn_decode: cache strides {st}, "
                         f"{v_cache.stride()}: rows must be contiguous")
    if (st[0] * k_cache.element_size()) % 16 or k_cache.data_ptr() % 16 \
            or v_cache.data_ptr() % 16:
        raise ValueError("attn_decode: cache rows must be 16-byte aligned")
    return kind, st[0]


def flash_decode_flat(q_heads, k_new, v_new, k_cache, v_cache, npast,
                      n_head_kv: int, head_dim: int,
                      k_scale=None, v_scale=None):
    """Decode attention for ONE token a slot over a flat cache.

    q_heads: (B, Hq, D) f32 UNscaled; k_new/v_new: (B, E_kv) element-order
    rows (unquantized floats even for INT8 caches); k_cache/v_cache:
    (B, T, E_kv) bf16 or int8 flat prefix views (row ``npast[b]`` stale);
    npast: int (B,); k_scale/v_scale: (B, T, H_kv) f32 for INT8 caches.
    Returns (B, Hq, D) f32."""
    _cache_kind(k_cache, v_cache)
    if not use_kernel(q_heads):
        return _decode_ref(q_heads, k_new, v_new, k_cache, v_cache, npast,
                           n_head_kv, head_dim, k_scale, v_scale)
    return _launch(q_heads, k_new, v_new, k_cache, v_cache, npast, n_head_kv,
                   head_dim, k_scale, v_scale, attn_layout=False)


def _launch(q_heads, k_new, v_new, k_cache, v_cache, npast, n_head_kv,
            head_dim, k_scale, v_scale, attn_layout: bool):
    """Check the operands and launch the kernel. q_heads (B, Hq, D): in the
    "attn" lane map the same memory is (B, n_rep, E_kv), and so is the
    output."""
    kind, batch_stride = _check(q_heads, k_new, v_new, k_cache, v_cache,
                                npast, n_head_kv, head_dim, k_scale, v_scale)
    B, Hq, D = q_heads.shape
    T = k_cache.shape[1]
    q32 = q_heads.to(torch.float32).contiguous()
    kn = k_new.to(torch.float32).contiguous()
    vn = v_new.to(torch.float32).contiguous()
    np32 = npast.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q_heads.device)
    sc_stride = k_scale.stride()[0] if k_scale is not None else 0
    fn = _build.entry("attn_decode")
    with torch.cuda.device(q_heads.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q32.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(),
                None if k_scale is None else k_scale.data_ptr(),
                None if v_scale is None else v_scale.data_ptr(),
                np32.data_ptr(), out.data_ptr(), B, n_head_kv,
                Hq // n_head_kv, T, D, batch_stride, sc_stride, kind,
                1.0 / D ** 0.5, int(attn_layout), stream)
    _build.check("attn_decode", rc)
    return out


def attn_to_elem(n_head_kv: int, head_dim: int, device=None) -> torch.Tensor:
    """Index long [E_kv]: lane p of an "attn"-map row holds the element
    ``attn_to_elem[p]`` of a head-major row with the same heads (first halves
    of the heads, then second halves). Attention is a dot over a head's
    features, so any such within-head order gives the same result."""
    half = head_dim // 2
    p = torch.arange(n_head_kv * half, device=device)
    first = (p // half) * head_dim + p % half
    return torch.cat([first, first + half])


def _decode_ref_attn(q_att, k_new, v_new, k_cache, v_cache, npast,
                     n_head: int, n_head_kv: int, head_dim: int):
    """Plain version of flash_decode_flat_attn: rows to element order,
    _decode_ref, the output back to the "attn" map."""
    B = q_att.shape[0]
    Ekv = n_head_kv * head_dim
    n_rep = n_head // n_head_kv
    a2e = attn_to_elem(n_head_kv, head_dim, q_att.device)
    inv = torch.argsort(a2e)
    # [B, n_rep, Ekv] attn map -> [B, n_rep, Hkv, D] -> heads hkv * n_rep + r
    q = q_att.reshape(B, n_rep, Ekv)[..., inv] \
        .reshape(B, n_rep, n_head_kv, head_dim).transpose(1, 2) \
        .reshape(B, n_head, head_dim)
    out = _decode_ref(q, k_new[..., inv], v_new[..., inv], k_cache[..., inv],
                      v_cache[..., inv], npast, n_head_kv, head_dim)
    out = out.reshape(B, n_head_kv, n_rep, head_dim).transpose(1, 2) \
        .reshape(B, n_rep, Ekv)[..., a2e]
    return out.reshape(B, n_rep * Ekv)


def flash_decode_flat_attn(q_att, k_new, v_new, k_cache, v_cache, npast,
                           n_head: int, n_head_kv: int, head_dim: int):
    """Decode attention over a flat cache whose rows are in the "attn" lane
    map. q_att: (B, E) f32 UNscaled query rows, n_rep consecutive E_kv blocks
    in that map; k_new/v_new: (B, E_kv); k_cache/v_cache: (B, T, E_kv) bf16
    prefix views (row ``npast[b]`` stale); npast: int (B,). Returns (B, E)
    f32 in the query's map."""
    B, E = q_att.shape
    Ekv = n_head_kv * head_dim
    if n_head % n_head_kv or E != n_head * head_dim:
        raise ValueError(f"attn_decode: q {tuple(q_att.shape)}, heads "
                         f"{n_head}/{n_head_kv}, head_dim {head_dim}")
    if _cache_kind(k_cache, v_cache) != 0:
        raise TypeError("attn_decode: the attn lane map takes a bf16 cache")
    if not use_kernel(q_att):
        return _decode_ref_attn(q_att, k_new, v_new, k_cache, v_cache, npast,
                                n_head, n_head_kv, head_dim)
    out = _launch(q_att.reshape(B, n_head, head_dim), k_new, v_new, k_cache,
                  v_cache, npast, n_head_kv, head_dim, None, None,
                  attn_layout=True)
    return out.reshape(B, E)
