"""Slot admission: bucketed single and batched prefill (one weight pass a
same-bucket admission group), chunked prefill for long prompts, and the
per-tick admission policy (port of ggmlsharp_tpu/serving/admission.py).
In spec mode (serving.spec) ``draft=True`` prefills the draft model's cache
with the draft's forward, config and parameters; its logits are dropped.

The JAX package jits a single admission a (bucket, total, cached, draft),
with the slot, the start row and the prompt length traced, and a grouped
admission a (bucket, G), G padded to a power of two <= batch_slots with
pad rows duplicating a real row. Here each is a ``captured.CapturedStep``
of the same keys: on the card one CUDA graph a key, not one a slot (the
slot, start and length are device inputs). Both run over a scratch cache
of their own (made once a shape, a static buffer of their graphs) and
write the engine's cache in place:
  * a single admission gathers the slot's first ``total`` rows (the rows
    its attention reads) into a one-slot scratch, prefills there and
    scatters back rows [start, start + bucket) and the slot's length;
  * a group prefills G rows of a bucket-sized scratch and scatters rows
    [0, bucket) and the lengths into its slots; a pad row writes its real
    row's values (gathered from that row), so the duplicate writes agree
    bit for bit.
The last logits come back as the step's output and are written into the
engine's ``_last_logits`` outside the graph (the decode step rebinds that
buffer). On the CPU, inside ``captured.disabled()`` and for a
tensor-parallel engine over gloo the same steps run eagerly (over NCCL
they are captured, the collectives in the graph).
"""
from __future__ import annotations

from collections import defaultdict

import torch

from ..models import kv_cache as kvc
from .common import _bucket


def _time_axis(c) -> int:
    """The time axis of the cache's buffers: 1 flat, 2 head-major."""
    return 1 if c.is_flat else 2


def _buffers(c):
    """Every row buffer of a cache (K, V, and the INT8 scales)."""
    return [*c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ())]


def _put_rows(x, src, slots, rows, ta):
    """x[slots[g], rows[g, j]] = src[g, j] along time axis ``ta`` (1: flat
    [B, T, X]; 2: head-major [B, H, T, X]), in place. src: G rows of
    ``rows.shape[1]`` time steps in x's layout; slots long [G]; rows long
    [G, S]."""
    G, S = rows.shape
    if ta == 1:
        X = x.shape[-1]
        idx = (slots[:, None] * x.shape[1] + rows).reshape(-1)
        x.view(-1, X).index_copy_(0, idx, src.reshape(-1, X))
    else:
        x.transpose(1, 2).index_put_((slots[:, None].expand(G, S), rows),
                                     src.transpose(1, 2))


class AdmissionMixin:
    def _model(self, draft: bool):
        """(forward, cfg, params, cache) of the target or the draft."""
        if draft:
            return self.d_forward, self.d_cfg, self.d_params, self.d_cache
        return self.forward, self.cfg, self.params, self.cache

    def _scratch(self, c, batch: int, rows: int):
        """A cache of ``c``'s layout with ``batch`` slots of ``rows`` rows,
        made once a (cache, batch, rows): the admissions' static scratch."""
        key = (id(c), batch, rows)
        sub = self._scratches.get(key)
        if sub is None:
            ta = _time_axis(c)

            def like(bufs):
                return None if bufs is None else [
                    torch.zeros((batch, *x.shape[1:ta], rows,
                                 *x.shape[ta + 1:]), dtype=x.dtype,
                                device=x.device) for x in bufs]

            sub = self._scratches[key] = kvc.KVCache(
                like(c.k), like(c.v), like(c.k_scale), like(c.v_scale),
                torch.zeros((batch,), dtype=torch.int32, device=c.k[0].device))
        return sub

    def _prefill_one_body(self, toks, where, bucket, total, cached, draft):
        """One admission (the JAX engine's per-bucket ``prefill``): toks
        [1, bucket], where int32 [3] = (slot, start, n). Gathers the slot's
        rows [0, total) into the scratch, prefills positions start.. there,
        scatters rows [start, start + bucket) back and sets the slot's
        length to start + n. Returns the last real token's logits [1, V].
        Run twice on the same inputs (a capture's warm-up, then its first
        replay) it writes the same rows and values: it reads the slot's
        rows below ``start``, which it never writes, and its own fresh rows,
        written before they are read; so the warm-up's writes are safe."""
        fwd, cfg, params, c = self._model(draft)
        sub = self._scratch(c, 1, total)
        ta = _time_axis(c)
        slot = where[0:1].long()
        start, n = where[1:2], where[2:3]
        for x, s in zip(_buffers(c), _buffers(sub)):
            torch.index_select(x.narrow(ta, 0, total), 0, slot, out=s)
        positions = start[:, None] + torch.arange(
            bucket, dtype=torch.int32, device=toks.device)[None]
        logits, _ = fwd(params, cfg, toks, sub, positions,
                        prefix_bound=total, cached_prefix=cached)
        rows = positions.long()
        for x, s in zip(_buffers(c), _buffers(sub)):
            _put_rows(x, s.index_select(ta, rows[0]), slot, rows, ta)
        c.length.index_copy_(0, slot, start + n)
        return logits[0].index_select(0, (n - 1).long())

    def _prefill_rows_body(self, toks, meta, bucket, G, draft):
        """A grouped admission (the JAX engine's ``prefill_many``): toks
        [G, bucket], meta int32 [3, G] = (slots, lengths, the row each row's
        values come from: itself, or the real row a pad row duplicates).
        Returns the rows' last logits [G, V]."""
        fwd, cfg, params, c = self._model(draft)
        sub = self._scratch(c, G, bucket)
        ta = _time_axis(c)
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=toks.device)[None].expand(G, bucket)
        logits, _ = fwd(params, cfg, toks, sub, positions,
                        prefix_bound=bucket)
        slots, n_real, src = meta[0].long(), meta[1], meta[2].long()
        rows = positions.long()
        for x, s in zip(_buffers(c), _buffers(sub)):
            _put_rows(x, s.index_select(0, src), slots, rows, ta)
        c.length.index_copy_(0, slots, n_real.index_select(0, src))
        last = logits[torch.arange(G, device=toks.device),
                      (n_real - 1).long()]
        return last.index_select(0, src)

    def _prefill_slot(self, req, slot: int, tokens=None, start: int = 0,
                      draft: bool = False):
        """Prefill ``tokens`` (default: req.prompt) into the slot's cache
        rows from row ``start`` (non-zero after a registered prefix was
        installed, or for a later chunk: positions and the slot's length
        are offset by it). draft=True: the draft model's cache. On the card
        a replay of the graph of its (bucket, total, cached, draft)."""
        tokens = req.prompt if tokens is None else tokens
        n = len(tokens)
        # the padded bucket must fit the rows from ``start`` (admission
        # guarantees start + n < max_len, so the cap stays >= n)
        bucket = min(_bucket(n), self.max_len - start)
        # live-prefix bound covering the installed prefix and this prompt
        total = min(_bucket(start + bucket), self.max_len)
        # a non-zero start: queries attend the rows below them (a flat
        # cache would otherwise flash over this call's fresh K/V only)
        cached = start > 0 or None
        toks = torch.zeros((1, bucket), dtype=torch.int32)
        toks[0, :n] = torch.tensor(tokens, dtype=torch.int32)
        where = torch.tensor([slot, start, n], dtype=torch.int32)
        self._n_prefills += 1
        last = self._prefill_one(self._upload(toks), self._upload(where),
                                 bucket=bucket, total=total, cached=cached,
                                 draft=draft)
        if not draft:  # draft logits are never sampled from
            self._last_logits[slot] = last[0]

    def _prefill_many(self, bucket: int, grp: list, tokens_of,
                      draft: bool = False):
        """Prefill the same-bucket prompts of ``grp`` [(req, slot)] in ONE
        forward, the group padded to G, a power of two <= batch_slots, by
        duplicates of its last row (as the JAX engine pads it): on the card
        a replay of the graph of its (bucket, G, draft). Then the slots'
        last logits (not for the draft)."""
        G = 1
        while G < len(grp):
            G *= 2
        G = min(G, self.B)
        toks = torch.zeros((G, bucket), dtype=torch.int32)
        meta = torch.zeros((3, G), dtype=torch.int32)
        for j in range(G):
            r = min(j, len(grp) - 1)  # a pad row: the last real row
            req, slot = grp[r]
            t = tokens_of(req)
            toks[j, :len(t)] = torch.tensor(t, dtype=torch.int32)
            meta[:, j] = torch.tensor([slot, len(t), r])
        meta = self._upload(meta)
        self._n_prefills += 1
        last = self._prefill_rows(self._upload(toks), meta, bucket=bucket,
                                  G=G, draft=draft)
        if not draft:
            self._last_logits.index_copy_(0, meta[0, :len(grp)].long(),
                                          last[:len(grp)])

    def _prefill_group(self, admits: list, draft: bool = False,
                       tokens_of=None):
        """Prefill a tick's plain admissions, same-bucket ones batched into
        one forward. draft=True prefills the draft model's cache
        (``tokens_of`` picks each request's tokens, e.g. prompt[:-1])."""
        tokens_of = tokens_of or (lambda r: r.prompt)
        groups = defaultdict(list)
        for req, slot in admits:
            groups[min(_bucket(len(tokens_of(req))), self.max_len)].append(
                (req, slot))
        for bucket, grp in groups.items():
            if len(grp) == 1:
                req, slot = grp[0]
                self._prefill_slot(req, slot, tokens=tokens_of(req),
                                   draft=draft)
            else:
                self._prefill_many(bucket, grp, tokens_of, draft)

    def _admit(self):
        plain, spec_plain = [], []
        for i in range(self.B):
            while self.slots[i] is None and self.pending:
                req = self.pending.pop(0)
                if len(req.prompt) >= self.max_len:
                    # would overflow the cache: reject up front (the caller
                    # sees done=True, no tokens)
                    self._reject(req, f"prompt length {len(req.prompt)} "
                                 f">= max_len {self.max_len}")
                    continue
                if len(req.prompt) + req.max_new_tokens > self.max_len:
                    req.max_new_tokens = self.max_len - len(req.prompt)
                if self.spec:
                    if (req.prefix_id is not None
                            or req.repeat_penalty != 1.0
                            or req.want_logprobs):
                        # the rejection and prefix paths stay per-slot
                        self._admit_spec(req, i)
                    elif self._validate_spec_cap(req):
                        self.slots[i] = req
                        if (self.prefill_chunk
                                and len(req.prompt) > self.prefill_chunk):
                            self._spec_chunking[i] = ("t", 0)
                        else:
                            spec_plain.append((req, i))
                    continue
                if req.prefix_id is not None:
                    pfx = self._prefixes.get(req.prefix_id)
                    if pfx is None:
                        self._reject(req,
                                     f"unknown prefix_id {req.prefix_id}")
                        continue
                    plen = pfx["plen"]
                    if req.prompt[:plen] != pfx["tokens"]:
                        self._reject(req, "prompt does not start with prefix")
                        continue
                    self.slots[i] = req
                    self._install_prefix(pfx["t"], plen, i, plen)
                    suffix = req.prompt[plen:]
                    if (suffix and self.prefill_chunk
                            and len(suffix) > self.prefill_chunk):
                        self._chunking[i] = plen  # chunk the suffix
                    elif suffix:
                        self._prefill_slot(req, i, tokens=suffix, start=plen)
                    else:  # prompt == prefix: reuse its stored last logits
                        self._last_logits[i] = pfx["t"]["last"]
                    continue
                self.slots[i] = req
                if (self.prefill_chunk
                        and len(req.prompt) > self.prefill_chunk):
                    self._chunking[i] = 0  # chunked prefill, one a tick
                else:
                    plain.append((req, i))
                break  # slot filled; prefill happens batched below
        if plain:
            self._prefill_group(plain)
        if spec_plain:
            self._admit_spec_batch(spec_plain)

    def _advance_chunks(self):
        """Prefill ONE chunk a chunking slot a tick; a slot joins decode
        the tick after its last chunk lands."""
        for i, pos in list(self._chunking.items()):
            req = self.slots[i]
            if req is None or req.done:  # cancelled mid-prefill
                del self._chunking[i]
                continue
            chunk = req.prompt[pos:pos + self.prefill_chunk]
            self._prefill_slot(req, i, tokens=chunk, start=pos)
            pos += len(chunk)
            if pos >= len(req.prompt):
                del self._chunking[i]  # _last_logits[i] now holds the end
            else:
                self._chunking[i] = pos
