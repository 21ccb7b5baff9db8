"""Batched single-token decode attention over a flat KV cache: the CUDA
kernel ``csrc/attn_decode.cu`` and its wrappers (port of
ggmlsharp_tpu/kernels/attn_decode.py::flash_decode_flat, layout "heads", and
::flash_decode_flat_attn, layout "attn").

Each slot's one query attends the cache rows t < min(npast[b], T) of a
flat [B, T, E_kv] cache (lane j belongs to KV head j // D) plus the fresh
token's unquantized K/V row, which stands in for the stale row npast[b].
The cache is bf16, or int8 with per-(token, head) scales [B, T, H_kv].
``mode`` is the mm_dot function (kernels.config; default the configured
one): "f32" runs in f32 throughout (the JAX kernel's exact mode); "bf16",
the JAX kernel's fast mode, rounds the scaled query to bf16 for the cache
rows' scores and each cache row's softmax weight (times its V scale, INT8)
to bf16 for the value products, with the softmax in base 2 against an
integer maximum so that the rounding does not depend on the order of the
rows (csrc/attn_decode.cu says why); the fresh row stays f32.

The kernel is bound by the bytes of the live rows. It splits each slot's
rows over ``decode_splits(B * H_kv, T)`` blocks a (slot, KV head), so that a
small batch or a long cache still fills the card; each block copies its
rows from the cache in their storage type (cp.async, double-buffered tiles
in shared memory), dequantizes them in registers into an online-softmax
state, and the last block of a (slot, KV head) to finish merges the
splits' states in the same launch (an f32 scratch from ``torch.empty`` and
arrival counters, one fixed buffer a stream). Against the dense reference
only the order of the f32 sums changes.

``flash_decode_flat_attn`` is the same function over rows in the "attn"
lane map of the JAX package's whole-block llama kernel: KV head h owns lanes
[h·D/2, (h+1)·D/2) and the same run at +E_kv/2, and the query and the output
are n_rep consecutive E_kv-wide blocks in that map. The kernel takes the map
as one more argument. The port's own caches stay in element order, so no path
of the port calls it; it is ported so the kernel is whole, and
``chip_smoke.py`` holds it against its plain version and times it.

The plain versions are ``_decode_ref``: dequantize, append the fresh row
as key T, mask the cache rows t >= npast, softmax, P.V, dense, in either
mode (``_decode_ref_attn``: permute to element order, ``_decode_ref``,
permute back), and ``_decode_ref_split``, the kernel's split algorithm (a
partial softmax state a split, then the merge) in plain f32 PyTorch. A
wrapper runs ``_decode_ref`` for a CPU tensor, and for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..ops.attention import NEG_INF
from ..ops.matmul import round_bf16
from . import _build
from .config import H100_SMS, device_sms, mm_dot_mode, round_x, use_kernel

_KV_KIND = {torch.bfloat16: 0, torch.int8: 1}
_BLOCKS_PER_SM = 4  # decode_splits: at most this many blocks an SM
_SPLIT_MIN_ROWS = 64  # cache rows a split takes at least
MAX_SPLITS = 512  # the most splits the kernel takes
_COUNTERS: dict = {}  # (device, stream) -> int32 arrival counters, all 0
_LOG2E = 1.4426950408889634  # log2(e), the base-2 softmax of mode "bf16"


def decode_splits(batch_heads: int, rows: int, sms: int = H100_SMS) -> int:
    """Splits of the cache rows a (slot, KV head) for one launch:
    ``batch_heads`` = B * H_kv blocks come before splitting, ``rows`` is the
    longest live prefix the launch may see (the view's T). As many splits
    as keep the grid within one wave of four blocks an SM (so at least two
    blocks an SM wherever the rows allow), but never fewer than 64 rows a
    split, never more splits than rows, never 0, never above MAX_SPLITS."""
    if batch_heads < 1 or rows < 1 or sms < 1:
        raise ValueError(f"decode_splits: batch_heads {batch_heads}, rows "
                         f"{rows}, sms {sms}")
    want = _BLOCKS_PER_SM * sms // batch_heads
    return max(1, min(want, rows // _SPLIT_MIN_ROWS, MAX_SPLITS))


def _counter(device, stream: int, n: int) -> torch.Tensor:
    """The int32 arrival counters of launches on ``stream`` of ``device``:
    zeroed once, left at 0 by every launch, and never reallocated, so a
    CUDA graph that captured their address stays valid. Launches on one
    stream run one at a time; another stream gets its own counters. They
    are as many as the blocks of one wave (``decode_splits`` splits only
    where B * H_kv is at most half that)."""
    buf = _COUNTERS.get((device, stream))
    if buf is None:
        buf = torch.zeros(_BLOCKS_PER_SM * device_sms(device),
                          dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    if n > buf.numel():
        raise ValueError(f"attn_decode: {n} split (slot, KV head) pairs, "
                         f"{buf.numel()} counters")
    return buf


def _dequant(rows, scale, n_head_kv):
    """Flat rows [B, T, E] (and scales [B, T, H] for int8) -> f32."""
    rows = rows.to(torch.float32)
    if scale is None:
        return rows
    B, T, E = rows.shape
    return (rows.reshape(B, T, n_head_kv, E // n_head_kv)
            * scale[..., None]).reshape(B, T, E)


def _decode_ref(q, k_new, v_new, k_cache, v_cache, npast, n_head_kv: int,
                head_dim: int, k_scale=None, v_scale=None, mode: str = "f32"):
    """Dense decode attention. q (B, Hq, D) UNscaled; k_new/v_new
    (B, E); k_cache/v_cache (B, T, E); npast int (B,) -> f32 (B, Hq, D).
    The fresh row is key T, always attended; cache row t is attended when
    t < npast[b] (so npast >= T attends all T rows, as the kernel does).
    mode: the mm_dot function, "f32" (all f32) or "bf16" (_decode_ref_bf16)."""
    if round_x(mode):
        return _decode_ref_bf16(q, k_new, v_new, k_cache, v_cache, npast,
                                n_head_kv, k_scale, v_scale)
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


def _decode_ref_bf16(q, k_new, v_new, k_cache, v_cache, npast,
                     n_head_kv: int, k_scale=None, v_scale=None):
    """The mm_dot "bf16" function of ``_decode_ref``: the cache rows' scores
    s = (bf16(q·D^-1/2) . k) · k_scale, the fresh row's s with the f32
    query; u = s·log2(e), M = ceil(max u) over the attended rows, p =
    2^(u - M); out = (sum_t bf16(p_t · v_scale_t) v_t + p_new v_new) /
    sum p (an int8 row's values unscaled; bf16 rows: scales 1)."""
    f32 = torch.float32
    B, Hq, D = q.shape
    T = k_cache.shape[1]
    n_rep = Hq // n_head_kv
    qg = (q.to(f32) * (1.0 / D ** 0.5)).reshape(B, n_head_kv, n_rep, D)
    kh = k_cache.to(f32).reshape(B, T, n_head_kv, D)
    vh = v_cache.to(f32).reshape(B, T, n_head_kv, D)
    s = torch.einsum("bgrd,btgd->bgrt", round_bf16(qg), kh)
    if k_scale is not None:
        s = s * k_scale.transpose(1, 2)[:, :, None, :]
    s_new = (qg * k_new.to(f32).reshape(B, n_head_kv, 1, D)).sum(-1)
    u = torch.cat([s * _LOG2E, (s_new * _LOG2E)[..., None]], -1)
    t = torch.arange(T + 1, device=q.device)
    npl = npast.to(device=q.device, dtype=torch.long)
    live = ((t[None, :] < npl[:, None]) | (t[None, :] == T))[:, None, None]
    u = torch.where(live, u, torch.full_like(u, NEG_INF))
    m = torch.ceil(u.amax(-1, keepdim=True))
    p = torch.where(live, torch.exp2(u - m), torch.zeros_like(u))
    w = p[..., :T]
    if v_scale is not None:
        w = w * v_scale.transpose(1, 2)[:, :, None, :]
    acc = torch.einsum("bgrt,btgd->bgrd", round_bf16(w), vh) \
        + p[..., T:] * v_new.to(f32).reshape(B, n_head_kv, 1, D)
    return (acc / p.sum(-1, keepdim=True)).reshape(B, Hq, D)


def _decode_ref_split(q, k_new, v_new, k_cache, v_cache, npast,
                      n_head_kv: int, head_dim: int, k_scale=None,
                      v_scale=None, splits: int = 1):
    """The kernel's algorithm in plain f32 PyTorch, arguments as
    ``_decode_ref``'s. Split z of ``splits`` takes the cache rows
    [z * chunk, (z + 1) * chunk), chunk = ceil(T / splits), that are live
    (t < npast[b]); split 0 also takes the fresh row. Each split keeps its
    own softmax state (m, l, acc); the states merge as
    out = sum_z acc_z e^(m_z - M) / sum_z l_z e^(m_z - M), M = max_z m_z.
    A split with no row has m = -inf-like, l = 0 and adds nothing."""
    B, Hq, D = q.shape
    T = k_cache.shape[1]
    if not 1 <= splits <= T:
        raise ValueError(f"_decode_ref_split: splits {splits} for T {T}")
    n_rep = Hq // n_head_kv
    chunk = -(-T // splits)
    pad = splits * chunk - T

    def heads(rows, scale):
        x = _dequant(rows, scale, n_head_kv).reshape(B, T, n_head_kv, D)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, splits, chunk, n_head_kv, D)

    kh, vh = heads(k_cache, k_scale), heads(v_cache, v_scale)
    qg = (q.to(torch.float32) * (1.0 / D ** 0.5)).reshape(B, n_head_kv,
                                                          n_rep, D)
    s = torch.einsum("bgrd,bzcgd->bgrzc", qg, kh)
    s_new = torch.einsum("bgrd,bgd->bgr", qg, k_new.to(torch.float32)
                         .reshape(B, n_head_kv, D))
    t = torch.arange(splits * chunk, device=q.device).reshape(splits, chunk)
    npl = npast.to(device=q.device, dtype=torch.long)
    live = t[None] < torch.minimum(npl, torch.full_like(npl, T))[:, None,
                                                                  None]
    # the fresh row: one more column, live in split 0 only
    fresh = torch.zeros((B, splits, 1), dtype=torch.bool, device=q.device)
    fresh[:, 0] = True
    live = torch.cat([live, fresh], -1)[:, None, None]  # [B, 1, 1, Z, C + 1]
    s = torch.cat([s, s_new[..., None, None].expand(*s.shape[:-1], 1)], -1)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)  # [B, G, R, Z]
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    v_new = v_new.to(torch.float32).reshape(B, 1, 1, n_head_kv, D)
    vz = torch.cat([vh, v_new.expand(B, splits, 1, n_head_kv, D)], 2)
    acc = torch.einsum("bgrzc,bzcgd->bgrzd", p, vz)
    M = m.amax(-1, keepdim=True)
    w = torch.exp(m - M)
    out = (acc * w[..., None]).sum(-2) / (l * w).sum(-1)[..., None]
    return out.reshape(B, Hq, D)


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


def _aligned(t):
    """t, or a fresh copy when its data is not 16-byte aligned (the
    kernel's vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_decode_flat(q_heads, k_new, v_new, k_cache, v_cache, npast,
                      n_head_kv: int, head_dim: int,
                      k_scale=None, v_scale=None, mode: str | None = None):
    """Decode attention for ONE token a slot over a flat cache.

    q_heads: (B, Hq, D) f32 UNscaled; k_new/v_new: (B, E_kv) element-order
    rows (unquantized floats even for INT8 caches); k_cache/v_cache:
    (B, T, E_kv) bf16 or int8 flat prefix views (row ``npast[b]`` stale);
    npast: int (B,); k_scale/v_scale: (B, T, H_kv) f32 for INT8 caches;
    mode: the mm_dot function (None: the configured one). Returns
    (B, Hq, D) f32."""
    _cache_kind(k_cache, v_cache)
    mode = mm_dot_mode() if mode is None else mode
    if not use_kernel(q_heads):
        return _decode_ref(q_heads, k_new, v_new, k_cache, v_cache, npast,
                           n_head_kv, head_dim, k_scale, v_scale, mode)
    return _launch(q_heads, k_new, v_new, k_cache, v_cache, npast, n_head_kv,
                   head_dim, k_scale, v_scale, attn_layout=False, mode=mode)


def _launch(q_heads, k_new, v_new, k_cache, v_cache, npast, n_head_kv,
            head_dim, k_scale, v_scale, attn_layout: bool, mode: str):
    """Check the operands and launch the kernel. q_heads (B, Hq, D): in the
    "attn" lane map the same memory is (B, n_rep, E_kv), and so is the
    output."""
    rnd = round_x(mode)
    kind, batch_stride = _check(q_heads, k_new, v_new, k_cache, v_cache,
                                npast, n_head_kv, head_dim, k_scale, v_scale)
    fn = _build.entry("attn_decode")
    B, Hq, D = q_heads.shape
    T = k_cache.shape[1]
    q32, kn, vn = (_aligned(x.to(torch.float32).contiguous())
                   for x in (q_heads, k_new, v_new))
    np32 = npast.to(torch.int32).contiguous()
    dev = q_heads.device
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    sc_stride = k_scale.stride()[0] if k_scale is not None else 0
    splits = decode_splits(B * n_head_kv, T, device_sms(dev))
    part = counter = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if splits > 1:
            part = torch.empty(B * n_head_kv * splits * Hq // n_head_kv
                               * (D + 2), dtype=torch.float32, device=dev)
            counter = _counter(dev, stream, B * n_head_kv)
        rc = fn(q32.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(),
                None if k_scale is None else k_scale.data_ptr(),
                None if v_scale is None else v_scale.data_ptr(),
                np32.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(),
                None if counter is None else counter.data_ptr(), B,
                n_head_kv, Hq // n_head_kv, T, D, batch_stride, sc_stride,
                kind, 1.0 / D ** 0.5, int(attn_layout), splits, rnd, stream)
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
                     n_head: int, n_head_kv: int, head_dim: int,
                     splits: int | None = None, mode: str = "f32"):
    """Plain version of flash_decode_flat_attn: rows to element order,
    _decode_ref in ``mode`` (or, given ``splits``, _decode_ref_split), the
    output back to the "attn" map."""
    B = q_att.shape[0]
    Ekv = n_head_kv * head_dim
    n_rep = n_head // n_head_kv
    a2e = attn_to_elem(n_head_kv, head_dim, q_att.device)
    inv = torch.argsort(a2e)
    # [B, n_rep, Ekv] attn map -> [B, n_rep, Hkv, D] -> heads hkv * n_rep + r
    q = q_att.reshape(B, n_rep, Ekv)[..., inv] \
        .reshape(B, n_rep, n_head_kv, head_dim).transpose(1, 2) \
        .reshape(B, n_head, head_dim)
    args = (q, k_new[..., inv], v_new[..., inv], k_cache[..., inv],
            v_cache[..., inv], npast, n_head_kv, head_dim)
    out = _decode_ref(*args, mode=mode) if splits is None else \
        _decode_ref_split(*args, splits=splits)
    out = out.reshape(B, n_head_kv, n_rep, head_dim).transpose(1, 2) \
        .reshape(B, n_rep, Ekv)[..., a2e]
    return out.reshape(B, n_rep * Ekv)


def flash_decode_flat_attn(q_att, k_new, v_new, k_cache, v_cache, npast,
                           n_head: int, n_head_kv: int, head_dim: int,
                           mode: str | None = None):
    """Decode attention over a flat cache whose rows are in the "attn" lane
    map. q_att: (B, E) f32 UNscaled query rows, n_rep consecutive E_kv blocks
    in that map; k_new/v_new: (B, E_kv); k_cache/v_cache: (B, T, E_kv) bf16
    prefix views (row ``npast[b]`` stale); npast: int (B,); mode as for
    flash_decode_flat. Returns (B, E) f32 in the query's map."""
    B, E = q_att.shape
    Ekv = n_head_kv * head_dim
    if n_head % n_head_kv or E != n_head * head_dim:
        raise ValueError(f"attn_decode: q {tuple(q_att.shape)}, heads "
                         f"{n_head}/{n_head_kv}, head_dim {head_dim}")
    if _cache_kind(k_cache, v_cache) != 0:
        raise TypeError("attn_decode: the attn lane map takes a bf16 cache")
    mode = mm_dot_mode() if mode is None else mode
    if not use_kernel(q_att):
        return _decode_ref_attn(q_att, k_new, v_new, k_cache, v_cache, npast,
                                n_head, n_head_kv, head_dim, mode=mode)
    out = _launch(q_att.reshape(B, n_head, head_dim), k_new, v_new, k_cache,
                  v_cache, npast, n_head_kv, head_dim, None, None,
                  attn_layout=True, mode=mode)
    return out.reshape(B, E)
