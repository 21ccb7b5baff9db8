"""KV cache: head-major or flat, float or INT8 (port of
ggmlsharp_tpu/models/kv_cache.py).

Two layouts a layer, one buffer for K and one for V:
  * head-major [B, H_kv, T, D] (bf16 by default);
  * flat [B, T, E_kv] token rows (lane j belongs to head j // D, the order
    ``merge_heads`` gives), read by the kernels that take whole token rows.
Which layout a model's ``new_cache`` picks by default, as the JAX package's:
  * llama: an INT8 cache is flat (serving: decode through the attn_decode
    kernel), a float one head-major (b = 1 decode: einsum attention);
  * gpt2: a float cache at batch 1 is flat (decode through the whole-block
    gpt2_layer kernel); batch > 1 or INT8 is head-major.
An INT8 cache stores int8 rows beside f32 absmax scales a (token, head):
[B, H_kv, T, 1] head-major, [B, T, H_kv] flat. ``length`` int32 [B] counts
the tokens filled in each batch slot.

Unlike the JAX package, whose functional updates XLA turns into in-place
writes under buffer donation, this port writes rows IN PLACE (one
``index_put_`` a head-major buffer, one ``index_copy_`` a flat one): a cache handed to ``update_layer`` or
``update_layer_flat`` is modified, and the returned cache shares its
buffers. The TPU write formulations (``_unroll_writes``) are not ported.
A forward returns its new ``length`` as a new tensor (``advance``); the
decode steps (``sampling``, the serving engine) write it into the cache's
own ``length`` with ``copy_``, so that the ``KVCache`` object and every
buffer address stay fixed for the CUDA graph that captures the step, as
admission, prefix installs and a freed slot write theirs in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass
class KVCache:
    k: list  # L x [B, H_kv, T, D] or L x [B, T, E_kv] (storage dtype or int8)
    v: list
    k_scale: list | None  # L x [B, H_kv, T, 1] or [B, T, H_kv] f32, INT8 only
    v_scale: list | None
    length: torch.Tensor  # [B] int32

    @property
    def int8(self) -> bool:
        return self.k[0].dtype == torch.int8

    @property
    def is_flat(self) -> bool:
        return self.k[0].dim() == 3

    @property
    def n_layer(self) -> int:
        return len(self.k)

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1 if self.is_flat else 2]


def init_cache(n_layer, batch, n_head_kv, n_ctx, head_dim,
               dtype=torch.bfloat16, int8: bool = False, flat: bool = False,
               device=None) -> KVCache:
    """flat=True: per-layer [B, T, H_kv * D] buffers of token rows.
    int8=True: int8 rows plus f32 scales (``dtype`` is then unused)."""
    device = resolve_device(device)
    if flat:
        shape, sshape = (batch, n_ctx, n_head_kv * head_dim), \
            (batch, n_ctx, n_head_kv)
    else:
        shape, sshape = (batch, n_head_kv, n_ctx, head_dim), \
            (batch, n_head_kv, n_ctx, 1)

    def bufs(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device)
                for _ in range(n_layer)]

    store = torch.int8 if int8 else dtype
    return KVCache(bufs(shape, store), bufs(shape, store),
                   bufs(sshape, torch.float32) if int8 else None,
                   bufs(sshape, torch.float32) if int8 else None,
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def is_flat(cache: KVCache) -> bool:
    """Whether ``cache`` is the flat [B, T, E_kv] layout (the JAX package's
    kv_cache.is_flat; the property ``cache.is_flat`` reads the same)."""
    return cache.is_flat


def _quant_rows(x):
    """[..., D] -> int8 values and an f32 scale a row (absmax / 127, round
    half to even, clip to +-127; a zero row gets scale 0 and values 0)."""
    amax = x.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    scale = amax / 127.0
    inv = torch.where(scale > 0,
                      1.0 / torch.where(scale > 0, scale,
                                        torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127)
    return q.to(torch.int8), scale


def _write_rows(buf, rows, positions):
    """Head-major buf[b, :, positions[b, s]] = rows[b, :, s] (buf
    [B, H, T, X], rows [B, H, S, X]), in one index_put_ through the
    [B, T, H, X] view."""
    B, S = positions.shape
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    buf.transpose(1, 2).index_put_((bidx, positions.long()),
                                   rows.to(buf.dtype).transpose(1, 2))
    return buf


def update_layer(cache: KVCache, layer: int, k_new, v_new,
                 positions) -> KVCache:
    """Write k_new/v_new [B, H_kv, S, D] at ``positions`` int [B, S] of one
    layer of a head-major cache, in place (INT8: quantized a (token, head)
    row). Returns ``cache``."""
    if cache.int8:
        for bufs, sbufs, rows in ((cache.k, cache.k_scale, k_new),
                                  (cache.v, cache.v_scale, v_new)):
            q, s = _quant_rows(rows)
            _write_rows(bufs[layer], q, positions)
            _write_rows(sbufs[layer], s, positions)
        return cache
    _write_rows(cache.k[layer], k_new, positions)
    _write_rows(cache.v[layer], v_new, positions)
    return cache


def read_layer(cache: KVCache, layer: int, compute_dtype=torch.float32,
               t: int | None = None):
    """K, V of one layer of a head-major cache as ``compute_dtype``
    [B, H_kv, t, D] (dequantized for INT8): the first ``t`` rows (all by
    default)."""
    t = cache.max_len if t is None else t
    k, v = cache.k[layer][:, :, :t], cache.v[layer][:, :, :t]
    if cache.int8:
        k = k.to(torch.float32) * cache.k_scale[layer][:, :, :t]
        v = v.to(torch.float32) * cache.v_scale[layer][:, :, :t]
    return k.to(compute_dtype), v.to(compute_dtype)


def flat_index(cache: KVCache, positions) -> torch.Tensor:
    """Row numbers long [B * S] of ``positions`` int [B, S] in a flat cache's
    buffers seen as [B * T, X]. It depends on the positions alone, so a
    forward makes it once and hands it to every layer's
    ``update_layer_flat``."""
    idx = positions.long()
    B = idx.shape[0]
    if B > 1:
        idx = idx + torch.arange(B, device=idx.device)[:, None] * cache.max_len
    return idx.reshape(-1)


def _write_flat(buf, rows, index):
    """buf [B, T, X] seen as [B * T, X]: rows [B, S, X] go to ``index``
    (flat_index), in one index_copy_."""
    X = buf.shape[-1]
    buf.view(-1, X).index_copy_(0, index, rows.reshape(-1, X).to(buf.dtype))


def update_layer_flat(cache: KVCache, layer: int, k_rows, v_rows,
                      positions, index=None) -> KVCache:
    """Write flat rows k_rows/v_rows [B, S, E] at ``positions`` int [B, S]
    of one layer of a flat cache, in place. ``index``: flat_index(cache,
    positions) where the caller made it already (once for all layers). INT8
    caches quantize a (token, head), the head-major granularity, with
    scales [B, S, H]. Returns ``cache``."""
    if index is None:
        index = flat_index(cache, positions)
    if cache.int8:
        H = cache.k_scale[layer].shape[-1]
        B, S, E = k_rows.shape
        for bufs, sbufs, rows in ((cache.k, cache.k_scale, k_rows),
                                  (cache.v, cache.v_scale, v_rows)):
            q, s = _quant_rows(rows.to(torch.float32).reshape(B, S, H, E // H))
            _write_flat(bufs[layer], q, index)
            _write_flat(sbufs[layer], s, index)
        return cache
    _write_flat(cache.k[layer], k_rows, index)
    _write_flat(cache.v[layer], v_rows, index)
    return cache


def read_layer_flat(cache: KVCache, layer: int, t: int):
    """The first ``t`` rows of one layer of a flat cache as f32
    [B, t, E] (dequantized for INT8)."""
    k, v = cache.k[layer][:, :t], cache.v[layer][:, :t]
    if not cache.int8:
        return k.to(torch.float32), v.to(torch.float32)
    B, _, E = k.shape
    H = cache.k_scale[layer].shape[-1]

    def deq(rows, s):
        return (rows.to(torch.float32).reshape(B, t, H, E // H)
                * s[:, :t, :, None]).reshape(B, t, E)

    return deq(k, cache.k_scale[layer]), deq(v, cache.v_scale[layer])


def advance(cache: KVCache, n) -> KVCache:
    """A cache over the same buffers with every slot ``n`` tokens longer."""
    return KVCache(cache.k, cache.v, cache.k_scale, cache.v_scale,
                   cache.length + n)
