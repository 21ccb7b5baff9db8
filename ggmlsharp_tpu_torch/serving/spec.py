"""Speculative continuous batching (port of ggmlsharp_tpu/serving/spec.py):
the Engine's draft/verify machinery, models.speculative composed with slot
admission. One propose/verify round a tick across every live slot, greedy
(rejection-sampled when a slot has temperature > 0), with chunked spec
prefill. The mixin runs only when Engine(draft_forward=...) turns spec mode
on.

Both caches are written in place. Every slot runs the round, idle and
chunking slots included; their lengths drift by 1..k+1 a round and are
clamped by the round (models.speculative._accept), freed slots are reset to
0 and a chunked admission's lengths are re-pinned when its last chunk lands.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.sampling import length_bucket, sample_token
from .request import Request, _stopped


class SpecServingMixin:
    def _validate_spec_cap(self, req: Request) -> bool:
        """Cap max_new_tokens to the speculative headroom (the verify writes
        k+1 rows past the current history every round); reject prompts that
        leave none."""
        cap = self.max_len - len(req.prompt) - self.spec_k - 2
        if cap <= 0:
            self._reject(req, f"prompt length {len(req.prompt)} leaves no "
                         f"speculative headroom (k={self.spec_k}, "
                         f"max_len={self.max_len})")
            return False
        req.max_new_tokens = min(req.max_new_tokens, cap)
        return True

    def _first_token(self, req: Request, slot: int) -> int:
        """a0 from the slot's last target logits: greedy argmax, or a draw
        of the request's sampler."""
        row = self._last_logits[slot:slot + 1]
        if req.temperature > 0:
            return int(sample_token(row, self._gen, req.temperature,
                                    req.top_k, req.top_p)[0, 0])
        return int(torch.argmax(row[0]))

    def _admit_spec(self, req: Request, slot: int):
        """Speculative admission of a request with a registered prefix (or
        one to reject): the target's and the draft's stored rows are
        installed and only the suffix is prefilled (the draft one token
        short), then the first token a0 and the slot's seed =
        [prompt[-1], a0] (the models.speculative round invariants)."""
        if req.repeat_penalty != 1.0 or req.want_logprobs:
            self._reject(req, "speculative engine supports temperature/"
                         "top_k/top_p but not repeat_penalty/want_logprobs")
            return
        pfx = None
        if req.prefix_id is not None:
            pfx = self._prefixes.get(req.prefix_id)
            if pfx is None:
                self._reject(req, f"unknown prefix_id {req.prefix_id}")
                return
            if req.prompt[:pfx["plen"]] != pfx["tokens"]:
                self._reject(req, "prompt does not start with prefix")
                return
        if not self._validate_spec_cap(req):
            return
        if pfx is None:
            # plain (no-prefix) spec admissions never reach here: _admit
            # batches them through _admit_spec_batch
            raise AssertionError("unreachable: plain spec admission")
        self.slots[slot] = req
        plen = pfx["plen"]
        suffix = req.prompt[plen:]
        self._install_prefix(pfx["t"], plen, slot, plen)
        if suffix:
            self._prefill_slot(req, slot, tokens=suffix, start=plen)
        else:  # prompt == prefix: the stored last logits are the sampler row
            self._last_logits[slot] = pfx["t"]["last"]
        a0 = self._first_token(req, slot)
        # the draft holds history[0:P-1]: the prefix rows, less the last
        # token when the prompt IS the prefix
        self._install_prefix(pfx["d"], plen, slot,
                             plen if suffix else plen - 1, draft=True)
        if len(suffix) > 1:
            self._prefill_slot(req, slot, tokens=suffix[:-1], start=plen,
                               draft=True)
        self._emit(req, a0)
        if _stopped(req) or len(req.out_tokens) >= req.max_new_tokens:
            self._finish_slot(req, slot)
            return
        self._seed[slot] = (req.prompt[-1], a0)

    def _advance_spec_chunks(self):
        """One chunk a chunking spec slot a tick: the target's chunks, then
        the draft's chunks of prompt[:-1], then finalize (first token and
        seed, the invariants _admit_spec_batch sets up)."""
        for i, (phase, pos) in list(self._spec_chunking.items()):
            req = self.slots[i]
            if req is None or req.done:  # cancelled mid-prefill
                del self._spec_chunking[i]
                continue
            if phase == "t":
                chunk = req.prompt[pos:pos + self.prefill_chunk]
                self._prefill_slot(req, i, tokens=chunk, start=pos)
                pos += len(chunk)
                if pos < len(req.prompt):
                    self._spec_chunking[i] = ("t", pos)
                    continue
                phase, pos = ("d", 0) if len(req.prompt) > 1 else ("f", 0)
            if phase == "d":
                dtoks = req.prompt[:-1]
                chunk = dtoks[pos:pos + self.prefill_chunk]
                self._prefill_slot(req, i, tokens=chunk, start=pos,
                                   draft=True)
                pos += len(chunk)
                if pos < len(dtoks):
                    self._spec_chunking[i] = ("d", pos)
                    continue
            # finalize: draft prefills never touch _last_logits, so the slot
            # row still holds the last TARGET chunk's logits. Re-pin both
            # lengths absolutely: rounds that ran during the draft phase
            # drifted the (garbage) lengths of the chunking slot
            P = len(req.prompt)
            self.cache.length[i], self.d_cache.length[i] = P, P - 1
            del self._spec_chunking[i]
            a0 = self._first_token(req, i)
            self._emit(req, a0)
            if _stopped(req) or len(req.out_tokens) >= req.max_new_tokens:
                self._finish_slot(req, i)
                continue
            self._seed[i] = (req.prompt[-1], a0)

    @torch.no_grad()
    def _spec_tick(self) -> bool:
        """One speculative engine tick: ONE draft-chain + verify round for
        every live slot, each emitting 1..k+1 tokens. Chunking slots advance
        one prefill chunk instead and sit out the round (their rows past the
        chunk are garbage that the next chunk or round overwrites)."""
        for i, req in enumerate(self.slots):  # externally cancelled slots
            if req is not None and req.done:
                self._finish_slot(req, i)
        if self._spec_chunking:
            self._advance_spec_chunks()
        live = [r for i, r in enumerate(self.slots)
                if r is not None and i not in self._spec_chunking]
        if not live:
            return bool(self._spec_chunking)
        hmax = max(len(r.prompt) + len(r.out_tokens) for r in live)
        t_eff = length_bucket(min(hmax + self.spec_k + 2, self.max_len),
                              self.max_len, base=64)
        seed = self._upload(torch.from_numpy(self._seed))
        if any(r is not None and r.temperature > 0 for r in self.slots):
            # the rejection-sampled round, per-slot sampling parameters;
            # greedy slots ride along at temperature 0 (one-hot
            # distributions: exact greedy prefix matching)
            temp = np.zeros((self.B,), np.float32)
            topk = np.zeros((self.B,), np.int32)
            topp = np.ones((self.B,), np.float32)
            for i, r in enumerate(self.slots):
                if r is not None and r.temperature > 0:
                    temp[i], topk[i], topp[i] = (r.temperature, r.top_k,
                                                 r.top_p)
            emitted, n_emit, self.cache, self.d_cache, seed = \
                self._spec_round_sampled(
                    self.params, self.d_params, self.cache, self.d_cache,
                    seed, self._gen, self._upload(torch.from_numpy(temp)),
                    self._upload(torch.from_numpy(topk)),
                    self._upload(torch.from_numpy(topp)),
                    t_eff=t_eff, d_eff=t_eff)
        else:
            emitted, n_emit, self.cache, self.d_cache, seed = \
                self._spec_round(self.params, self.d_params, self.cache,
                                 self.d_cache, seed, t_eff=t_eff,
                                 d_eff=t_eff)
        self._n_forwards += 1
        em, ne = emitted.cpu().numpy(), n_emit.cpu().numpy()
        self._seed = seed.cpu().numpy().copy()  # writable: admits set rows
        for i, req in enumerate(self.slots):
            if req is None or i in self._spec_chunking:
                continue
            for j in range(int(ne[i])):
                self._emit(req, int(em[i, j]))
                if _stopped(req) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    break
            if req.done:
                self._finish_slot(req, i)
        return True

    def _admit_spec_batch(self, admits: list):
        """Batched speculative admission: ONE grouped target prefill for the
        burst, one argmax fetch for every greedy first token, then ONE
        grouped draft prefill of the prompts[:-1] (the round invariant: the
        draft holds history[0:P-1])."""
        self._prefill_group(admits)
        gtoks = torch.argmax(self._last_logits, dim=-1).cpu().numpy()
        drafts = []
        for req, slot in admits:
            a0 = self._first_token(req, slot) if req.temperature > 0 \
                else int(gtoks[slot])
            self._emit(req, a0)
            if _stopped(req) or len(req.out_tokens) >= req.max_new_tokens:
                self._finish_slot(req, slot)
                continue
            self._seed[slot] = (req.prompt[-1], a0)
            if len(req.prompt) > 1:
                drafts.append((req, slot))
        if drafts:
            self._prefill_group(drafts, draft=True,
                                tokens_of=lambda r: r.prompt[:-1])

