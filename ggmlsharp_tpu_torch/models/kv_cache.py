"""Head-major KV cache (port of ggmlsharp_tpu/models/kv_cache.py).

One [B, H_kv, T, D] buffer per layer for K and one for V (bf16 by default),
plus ``length`` int32 [B], the tokens filled in each batch slot. Unlike the
JAX package, whose functional updates XLA turns into in-place writes under
buffer donation, this port writes rows IN PLACE (``index_copy_``): a cache
handed to ``update_layer`` is modified, and the returned cache shares its
buffers. The flat [B, T, E_kv] and INT8 caches are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass
class KVCache:
    k: list  # L x [B, H_kv, T, D]
    v: list
    length: torch.Tensor  # [B] int32

    @property
    def n_layer(self) -> int:
        return len(self.k)

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]


def init_cache(n_layer, batch, n_head_kv, n_ctx, head_dim,
               dtype=torch.bfloat16, device=None) -> KVCache:
    device = resolve_device(device)
    shape = (batch, n_head_kv, n_ctx, head_dim)
    return KVCache(
        [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)],
        [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)],
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def update_layer(cache: KVCache, layer: int, k_new, v_new, positions) -> KVCache:
    """Write k_new/v_new [B, H_kv, S, D] at ``positions`` int [B, S] of one
    layer, in place (rows cast to the cache dtype). Returns ``cache``."""
    idx = positions.long()
    for buf, rows in ((cache.k[layer], k_new), (cache.v[layer], v_new)):
        rows = rows.to(buf.dtype)
        for b in range(buf.shape[0]):
            buf[b].index_copy_(1, idx[b], rows[b])
    return cache


def read_layer(cache: KVCache, layer: int, compute_dtype=torch.float32,
               t: int | None = None):
    """K, V of one layer as ``compute_dtype`` [B, H_kv, t, D]: the first
    ``t`` rows (all by default)."""
    t = cache.max_len if t is None else t
    return (cache.k[layer][:, :, :t].to(compute_dtype),
            cache.v[layer][:, :, :t].to(compute_dtype))


def advance(cache: KVCache, n) -> KVCache:
    """A cache over the same buffers with every slot ``n`` tokens longer."""
    return KVCache(cache.k, cache.v, cache.length + n)
