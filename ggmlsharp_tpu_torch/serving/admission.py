"""Slot admission: bucketed single and batched prefill (one weight pass a
same-bucket admission group), chunked prefill for long prompts, and the
per-tick admission policy (port of ggmlsharp_tpu/serving/admission.py).
In spec mode (serving.spec) ``draft=True`` prefills the draft model's cache
with the draft's forward, config and parameters; its logits are dropped.

The cache is written in place: a single admission runs the forward over
the slot's own rows (a batch-1 view of every buffer); a group runs it over
a bucket-sized scratch cache whose rows are then scattered into the slots.
The JAX package pads a group to a power of two and installs a full burst
by a static slice to bound its compiled executables; eager PyTorch
compiles nothing, so a group here is exactly its requests.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from ..models import kv_cache as kvc
from .common import _bucket


class AdmissionMixin:
    def _model(self, draft: bool):
        """(forward, cfg, params, cache) of the target or the draft."""
        if draft:
            return self.d_forward, self.d_cfg, self.d_params, self.d_cache
        return self.forward, self.cfg, self.params, self.cache

    def _prefill_slot(self, req, slot: int, tokens=None, start: int = 0,
                      draft: bool = False):
        """Prefill ``tokens`` (default: req.prompt) into the slot's cache
        rows from row ``start`` (non-zero after a registered prefix was
        installed, or for a later chunk: positions and the slot's length
        are offset by it). draft=True: the draft model's cache."""
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
        fwd, cfg, params, c = self._model(draft)

        def one(bufs):
            return None if bufs is None else [x[slot:slot + 1] for x in bufs]

        sub = kvc.KVCache(one(c.k), one(c.v), one(c.k_scale),
                          one(c.v_scale), c.length[slot:slot + 1])
        positions = start + torch.arange(bucket, dtype=torch.int32,
                                         device=self.device)[None]
        self._n_prefills += 1
        logits, _ = fwd(params, cfg, self._upload(toks), sub, positions,
                        prefix_bound=total, cached_prefix=cached)
        c.length[slot] = start + n
        if not draft:  # draft logits are never sampled from
            self._last_logits[slot] = logits[0, n - 1]

    def _prefill_many(self, bucket: int, grp: list, tokens_of,
                      draft: bool = False):
        """Prefill the G same-bucket prompts of ``grp`` [(req, slot)] in ONE
        forward over a bucket-sized scratch cache, then scatter its rows,
        the slots' lengths and (not for the draft) their last logits."""
        G = len(grp)
        fwd, cfg, params, c = self._model(draft)
        toks = torch.zeros((G, bucket), dtype=torch.int32)
        n_real = torch.zeros((G,), dtype=torch.long)
        for j, (req, _) in enumerate(grp):
            t = tokens_of(req)
            toks[j, :len(t)] = torch.tensor(t, dtype=torch.int32)
            n_real[j] = len(t)
        slots = self._upload(torch.tensor([s for _, s in grp]))
        n_real = self._upload(n_real)
        sub = kvc.init_cache(cfg.n_layer, G,
                             getattr(cfg, "n_head_kv", cfg.n_head), bucket,
                             cfg.head_dim, dtype=c.k[0].dtype,
                             int8=c.int8, flat=c.is_flat, device=self.device)
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device)[None].expand(G, bucket)
        self._n_prefills += 1
        logits, sub = fwd(params, cfg, self._upload(toks), sub, positions,
                          prefix_bound=bucket)
        head = slice(0, bucket)
        for bufs, subs in ((c.k, sub.k), (c.v, sub.v),
                           (c.k_scale, sub.k_scale), (c.v_scale, sub.v_scale)):
            for x, s in zip(bufs or (), subs or ()):
                if c.is_flat:
                    x[slots, head] = s
                else:
                    x[slots, :, head] = s
        c.length[slots] = n_real.to(torch.int32)
        if not draft:
            last = logits[torch.arange(G, device=self.device), n_real - 1]
            self._last_logits[slots] = last

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
