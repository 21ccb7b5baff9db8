"""Prefix caching: precomputed KV rows for shared prompt prefixes
(register_prefix/drop_prefix and the per-admission install; port of
ggmlsharp_tpu/serving/prefix.py). In spec mode a prefix also keeps the draft
model's rows."""
from __future__ import annotations

import torch

from ..models import kv_cache as kvc
from ..models.common import cache_heads
from .common import _bucket


class PrefixCacheMixin:
    def _compute_prefix_rows(self, tokens, plen: int,
                             draft: bool = False) -> dict:
        """Prefill ``tokens`` into a fresh 1-slot cache of the engine
        cache's layout (the draft's with draft=True) and keep exactly the
        prefix rows and the last token's logits."""
        fwd, cfg, params, proto = self._model(draft)
        bucket = min(_bucket(plen), self.max_len)
        cache = kvc.init_cache(
            cfg.n_layer, 1, cache_heads(cfg, params), bucket,
            cfg.head_dim,
            dtype=proto.k[0].dtype if not proto.int8 else torch.bfloat16,
            int8=proto.int8, flat=proto.is_flat, device=self.device)
        toks = torch.zeros((1, bucket), dtype=torch.int32)
        toks[0, :plen] = torch.tensor(tokens, dtype=torch.int32)
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device)[None]
        with torch.no_grad():
            logits, c2 = fwd(params, cfg, self._upload(toks), cache,
                             positions, prefix_bound=bucket)

        def cut(bufs):  # keep exactly the prefix rows (time axis 1 or 2)
            return None if bufs is None else [
                x[:, :plen] if proto.is_flat else x[:, :, :plen]
                for x in bufs]

        return dict(k=cut(c2.k), v=cut(c2.v), ks=cut(c2.k_scale),
                    vs=cut(c2.v_scale), last=logits[0, plen - 1])

    def register_prefix(self, tokens: list) -> int:
        """Prefill a shared prompt prefix ONCE and keep its KV rows on the
        device; requests carrying the returned id skip recomputing it:
        admission copies the rows into the slot and prefills only the
        remainder. In spec mode the draft model's rows are kept too."""
        plen = len(tokens)
        if not 0 < plen < self.max_len:
            raise ValueError(f"prefix length {plen} must be in (0, "
                             f"{self.max_len})")
        entry = dict(tokens=list(tokens), plen=plen,
                     t=self._compute_prefix_rows(tokens, plen),
                     d=(self._compute_prefix_rows(tokens, plen, draft=True)
                        if self.spec else None))
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = entry
        return pid

    def drop_prefix(self, prefix_id: int):
        self._prefixes.pop(prefix_id, None)

    def _install_prefix(self, rows: dict, plen: int, slot: int,
                        set_len: int, draft: bool = False):
        """Write ``rows`` into cache rows [0:plen] of ``slot`` (of the
        draft's cache with draft=True) and set its length to ``set_len``, in
        place (the draft sits one token behind when the prompt IS the
        prefix)."""
        c = self.d_cache if draft else self.cache
        for bufs, src in ((c.k, rows["k"]), (c.v, rows["v"]),
                          (c.k_scale, rows["ks"]), (c.v_scale, rows["vs"])):
            for x, r in zip(bufs or (), src or ()):
                if c.is_flat:
                    x[slot, :plen] = r[0]
                else:
                    x[slot, :, :plen] = r[0]
        c.length[slot] = set_len
