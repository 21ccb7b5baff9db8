"""Continuous-batching inference engine (port of
ggmlsharp_tpu/serving/engine.py without a device mesh).

Slot-based design:
  * B fixed slots share one batched KV cache; per-slot lengths live in
    cache.length, so a finished request frees its slot without reshaping
    anything.
  * admission = bucketed prefill (serving.admission): same-bucket
    admissions batch into ONE forward; prompts are padded up to the
    bucket, and the pad rows land at positions >= the prompt length, where
    decode never attends them before overwriting them.
  * decode = ONE batched single-token step for all B slots a tick; empty
    and finished slots run with pad tokens and do not advance.
  * decode windows: when every live slot is greedy, up to W steps run back
    to back with every carried value (logits, cache, token columns) on the
    device and ONE fetch at the end; requests whose budget ends inside the
    window free their slot at dispatch, and the next admission's prefill
    is queued behind the window.
  * speculative mode (``draft_forward=``, serving.spec): each tick is one
    draft-propose / target-verify round over all slots instead, 1..k+1
    tokens a slot; it runs no decode windows.
The host never reads a device tensor a slot a step: the live-prefix bound
and ``active`` come from host-side request lengths, and one fetch a tick
(or a window) brings the tokens back.

An INT8 cache takes the flat [B, T, E_kv] layout, whose decode runs the
attn_decode kernel, when the model handles it (``cfg.supports_flat_kv``) and
n_head_kv * head_dim is a multiple of 128; otherwise (every GPT-2, narrow
llamas) it is head-major, as in the JAX engine. A plain engine (the
kernels' plain versions on any device) is
``Engine(functools.partial(llama.forward, plain=True), ...)``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import batch_slots as _batch_slots_default
from ..config import int8_kv as _int8_kv_default
from ..device import resolve_device
from ..models import kv_cache as kvc
from ..models.sampling import _recent_window, length_bucket, sample_token
from ..models.speculative import make_spec_round, make_spec_round_sampled
from .admission import AdmissionMixin
from .prefix import PrefixCacheMixin
from .request import Request, _stopped
from .spec import SpecServingMixin

__all__ = ["Engine", "Request"]


def _flat_layout(cfg, int8_kv: bool) -> bool:
    """The JAX engine's layout rule under its default switch: an INT8 cache
    of a model that handles the flat layout, with E_kv a multiple of 128,
    is flat (decode through attn_decode); every other cache is head-major
    (decode through cached_attention over read_layer)."""
    n_head_kv = getattr(cfg, "n_head_kv", cfg.n_head)
    return bool(int8_kv and (n_head_kv * cfg.head_dim) % 128 == 0
                and getattr(cfg, "supports_flat_kv", False))


class Engine(AdmissionMixin, PrefixCacheMixin, SpecServingMixin):
    def __init__(self, forward, cfg, params, batch_slots: int | None = None,
                 max_len: int | None = None, cache_dtype=torch.float32,
                 int8_kv: bool | None = None, rng_seed: int = 0,
                 draft_forward=None, draft_cfg=None, draft_params=None,
                 spec_k: int = 4, prefill_chunk: int | None = None,
                 multi_step: int | None = None, device=None):
        """forward(params, cfg, tokens, cache, positions, prefix_bound=,
        cached_prefix=) is the model (llama.forward); params live on
        ``device`` (the card unless the caller asks for the CPU).

        draft_forward / draft_cfg / draft_params: speculative continuous
        batching (serving.spec). Every tick runs one draft-propose /
        target-verify round across all live slots (models.speculative),
        1..k+1 tokens a slot a target forward, spec_k drafts a round.
        Greedy slots get the target's own greedy tokens; slots with
        temperature > 0 take the rejection-sampled round; repeat_penalty
        and want_logprobs are refused. The draft's cache follows the same
        layout rule as the target's; draft_cfg defaults to cfg and must
        share its vocabulary.

        batch_slots: None reads GGML_TPU_BATCH_SLOTS (config.batch_slots,
        default 4). int8_kv: None reads GGML_TPU_INT8_KV. An INT8 cache takes the flat
        layout where E_kv is a multiple of 128 and the model handles it,
        the head-major one otherwise; a float cache is head-major.

        prefill_chunk: split prompts longer than this into one chunk a tick,
        so one long admission cannot hold up decode for the live slots.

        multi_step: decode-window length W (default GGML_TPU_SERVE_MULTISTEP,
        32; 1 disables). A window runs when every live slot is greedy and
        penalty-free and nothing is pending for a free slot or chunking;
        it is clamped to the smallest remaining budget. Stop sequences and
        eos still cut a request inside a window (the extra rows in its
        freed slot are dead). A slot with an on_token callback (a
        streaming client) forces single steps, for per-token latency and
        cancel()."""
        self.forward = forward
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        if batch_slots is None:
            batch_slots = _batch_slots_default()
        self.B = batch_slots
        self._n_head_kv = getattr(cfg, "n_head_kv", cfg.n_head)
        self.max_len = max_len or cfg.n_ctx
        if int8_kv is None:
            int8_kv = _int8_kv_default()
        self.int8_kv = int8_kv
        self.cache = kvc.init_cache(
            cfg.n_layer, batch_slots, self._n_head_kv, self.max_len,
            cfg.head_dim, dtype=cache_dtype, int8=int8_kv,
            flat=_flat_layout(cfg, int8_kv), device=self.device)
        self.slots: list[Request | None] = [None] * batch_slots
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self._last_logits = torch.zeros((batch_slots, cfg.n_vocab),
                                        dtype=torch.float32,
                                        device=self.device)
        self._gen = torch.Generator(self.device).manual_seed(rng_seed)
        self._prefixes: dict[int, dict] = {}
        self._next_prefix_id = 0
        self.prefill_chunk = prefill_chunk
        self._chunking: dict[int, int] = {}  # slot -> next prompt offset
        self._n_ticks = self._n_emitted = self._n_prefills = 0
        self._n_forwards = 0  # decode forward calls (windows included)
        self._n_preadmits = 0  # slots re-filled behind an in-flight window
        # pre-admitted requests removed from their slots at dispatch and
        # finished at drain: cancel() consults this in that span
        self._inflight_pre: dict[int, Request] = {}
        self._lat_sum = self._ttft_sum = 0.0
        self._lat_n = self._ttft_n = 0
        self._t_first = None
        self.multi_step = (multi_step if multi_step is not None
                           else int(os.environ.get(
                               "GGML_TPU_SERVE_MULTISTEP", "32")))

        # speculative mode
        self.spec = draft_forward is not None
        if self.spec:
            self.d_forward = draft_forward
            self.d_cfg = draft_cfg or cfg
            self.d_params = draft_params
            self.spec_k = spec_k
            self.d_cache = kvc.init_cache(
                self.d_cfg.n_layer, batch_slots,
                getattr(self.d_cfg, "n_head_kv", self.d_cfg.n_head),
                self.max_len, self.d_cfg.head_dim, dtype=cache_dtype,
                int8=int8_kv, flat=_flat_layout(self.d_cfg, int8_kv),
                device=self.device)
            self._spec_round = make_spec_round(
                forward, cfg, draft_forward, self.d_cfg, spec_k)
            self._spec_round_sampled = make_spec_round_sampled(
                forward, cfg, draft_forward, self.d_cfg, spec_k)
            self._seed = np.zeros((batch_slots, 2), np.int32)
            # spec chunking: slot -> (phase "t" | "d", next offset); the
            # target's chunks, then the draft's of prompt[:-1], then a0
            self._spec_chunking: dict[int, tuple] = {}

    # --- device pieces ---------------------------------------------------
    def _upload(self, x):
        """A host tensor on the engine's device without a host sync (pinned
        staging; the caching host allocator keeps it alive until the copy
        ran)."""
        if self.device.type != "cuda":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    @torch.no_grad()
    def _step(self, tokens, active, t_eff: int):
        """One batched decode forward; only ``active`` slots advance.
        Returns the next logits [B, V]."""
        positions = self.cache.length[:, None]
        logits, cache = self.forward(self.params, self.cfg, tokens,
                                     self.cache, positions,
                                     prefix_bound=t_eff)
        self.cache = kvc.KVCache(
            cache.k, cache.v, cache.k_scale, cache.v_scale,
            torch.where(active, cache.length, cache.length - 1))
        self._n_forwards += 1
        return logits[:, -1, :]

    def _active(self):
        return self._upload(torch.tensor(
            [s is not None and not s.done and i not in self._chunking
             for i, s in enumerate(self.slots)], dtype=torch.bool))

    # --- decode windows --------------------------------------------------
    def _window_k(self, ready, greedy) -> int:
        """Decode-window length for this tick: up to multi_step when EVERY
        live slot is greedy and penalty-free, no slot is free while
        requests wait, none is chunking and none streams; clamped to the smallest remaining budget and the cache
        headroom, so no slot oversteps its budget. 1 means a single step."""
        W = self.multi_step
        if W <= 1 or self._chunking:
            return 1
        if self.pending and any(s is None for s in self.slots):
            return 1  # a slot is free: admit before windowing
        if not any(ready) or ready != greedy:
            return 1
        # snapshot: a cancel() on another thread may null slots mid-scan
        occupied = [s for s in list(self.slots) if s is not None]
        if not occupied or any(s.done for s in occupied):
            return 1
        if any(s.on_token is not None for s in occupied):
            return 1  # streaming wants per-token latency
        L = max(len(s.prompt) + len(s.out_tokens) for s in occupied)
        rem = min(s.max_new_tokens - len(s.out_tokens) for s in occupied)
        return max(1, min(W, rem, self.max_len - L))

    @torch.no_grad()
    def _dispatch_window(self, k: int) -> dict:
        """Queue k greedy decode steps (no fetch) and the admission behind
        them; returns the drain record."""
        window_reqs = list(self.slots)  # the requests the window runs for
        active = self._active()
        live = [len(s.prompt) + len(s.out_tokens)
                for s in window_reqs if s is not None]
        t_eff = length_bucket(min(max(live, default=1) + k, self.max_len),
                              self.max_len, base=64)
        want_lps = any(s is not None and s.want_logprobs
                       for s in window_reqs)
        logits = self._last_logits
        tcols, lcols = [], []
        for _ in range(k):
            tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
            if want_lps:
                lcols.append(torch.gather(
                    torch.log_softmax(logits, dim=-1), 1, tok.long()))
            tcols.append(tok)
            logits = self._step(tok, active, t_eff)
        self._last_logits = logits
        pre: dict[int, Request] = {}
        if self.pending and not self._chunking:
            # a slot whose budget ends inside the window is free after it:
            # admit behind the window
            for i, req in enumerate(self.slots):
                if req is not None and not req.done and \
                        req.max_new_tokens - len(req.out_tokens) <= k:
                    pre[i] = req
            if pre:
                for i, r in pre.items():
                    self.slots[i] = None
                    self._inflight_pre[r.id] = r
                self._n_preadmits += len(pre)
                self._admit()
        return {"k": k, "reqs": window_reqs, "toks": torch.cat(tcols, 1),
                "lps": torch.cat(lcols, 1) if lcols else None, "pre": pre}

    def _drain_window(self, rec: dict):
        """Fetch one window's tokens and do the host-side emit, stop and
        budget bookkeeping."""
        k, pre = rec["k"], rec["pre"]
        toks = rec["toks"].cpu().numpy()  # ONE fetch for the whole window
        lps = rec["lps"].cpu().numpy() if rec["lps"] is not None else None
        for i, req in enumerate(rec["reqs"]):
            if req is None:
                continue
            for j in range(k):
                if req.done:
                    break
                self._emit(req, int(toks[i, j]))
                if req.want_logprobs:
                    req.out_logprobs.append(float(lps[i, j]))
                if _stopped(req) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
        for i, req in pre.items():
            req.done = True
            self._inflight_pre.pop(req.id, None)
            if req.t_done is None:  # not already finished (e.g. cancelled)
                self._finished(req)
            if self.slots[i] is None:  # nothing was admitted: free it
                self._free_slot(i)
            # else: the admitted request's prefill set the slot length
        for i, req in enumerate(self.slots):
            if req is not None and i not in pre and req.done:
                self._finish_slot(req, i)

    # --- request bookkeeping ----------------------------------------------
    def _free_slot(self, i: int):
        self.cache.length[i] = 0
        if self.spec:
            self.d_cache.length[i] = 0

    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.pending.append(req)

    def _emit(self, req: Request, tok: int):
        """Record one generated token and fire the streaming callback."""
        if req.t_first_token is None:
            req.t_first_token = time.perf_counter()
        req.out_tokens.append(tok)
        self._n_emitted += 1
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finished(self, req: Request):
        req.t_done = time.perf_counter()
        if req.t_submit is not None:
            self._lat_sum += req.t_done - req.t_submit
            self._lat_n += 1
            if req.t_first_token is not None:
                self._ttft_sum += req.t_first_token - req.t_submit
                self._ttft_n += 1
        self.finished.append(req)

    def _reject(self, req: Request, error: str):
        req.done, req.error = True, error
        self._finished(req)

    def _finish_slot(self, req: Request, slot: int):
        """Retire a done request and free its slot (cache length reset)."""
        req.done = True
        self._finished(req)
        self.slots[slot] = None
        self._free_slot(slot)

    def cancel(self, request_id: int) -> bool:
        """Cancel a pending or live request (error='cancelled'); its slot
        frees at once and the partial output stays on the request."""
        for j, r in enumerate(self.pending):
            if r.id == request_id:
                r.done, r.error = True, "cancelled"
                self._finished(self.pending.pop(j))
                return True
        for i, r in enumerate(self.slots):
            if r is not None and r.id == request_id:
                r.done, r.error = True, "cancelled"
                self._finished(r)
                self.slots[i] = None
                self._free_slot(i)
                return True
        # pre-admitted behind an undrained window: flag it done so the
        # drain skips its tokens (and does not finish it twice)
        r = self._inflight_pre.pop(request_id, None)
        if r is not None and r.t_done is None:
            r.done, r.error = True, "cancelled"
            self._finished(r)
            return True
        return False

    def stats(self) -> dict:
        """Engine counters: ticks, emitted tokens, prefill and decode
        forward calls, queue and slot occupancy, rolling tokens/s since
        the first tick, mean time to first token and latency."""
        dt = (time.perf_counter() - self._t_first) \
            if self._t_first is not None else 0.0
        return {
            "ticks": self._n_ticks,
            "tokens_emitted": self._n_emitted,
            "prefill_dispatches": self._n_prefills,
            "decode_forwards": self._n_forwards,
            "speculative_admissions": self._n_preadmits,
            "queue_depth": len(self.pending),
            "live_slots": sum(s is not None for s in self.slots),
            "finished": len(self.finished),
            "tokens_per_s": (self._n_emitted / dt) if dt > 0 else 0.0,
            "mean_ttft_s": (self._ttft_sum / self._ttft_n)
            if self._ttft_n else None,
            "mean_latency_s": (self._lat_sum / self._lat_n)
            if self._lat_n else None,
        }

    # --- the tick ----------------------------------------------------------
    @torch.no_grad()
    def step_once(self):
        """One engine tick: admit, then a decode window or one batched
        decode step (greedy slots sample in one fused argmax fetch; a slot
        with sampling parameters samples its own logits row). Speculative
        mode: one draft/verify round instead (1..k+1 tokens a slot)."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        self._n_ticks += 1
        self._admit()
        if self.spec:
            return self._spec_tick()
        if self._chunking:
            self._advance_chunks()
        if all(s is None for s in self.slots):
            return False
        if all(i in self._chunking
               for i, s_ in enumerate(self.slots) if s_ is not None):
            return True  # everything still prefilling; nothing to decode

        ready = [s is not None and i not in self._chunking
                 for i, s in enumerate(self.slots)]
        greedy = [r and s.temperature <= 0.0 and s.repeat_penalty == 1.0
                  for r, s in zip(ready, self.slots)]
        k = self._window_k(ready, greedy)
        if k > 1:  # all-greedy k-token window: k steps, one fetch
            self._drain_window(self._dispatch_window(k))
            return True
        toks = np.zeros((self.B, 1), np.int32)
        gtoks = torch.argmax(self._last_logits, dim=-1).cpu().numpy() \
            if any(greedy) else None
        for i, req in enumerate(self.slots):
            if req is None or not ready[i] or req.done:
                continue  # empty, chunking, or cancelled externally
            if greedy[i]:
                tok = int(gtoks[i])
            else:
                win = (req.repeat_last_n
                       if req.repeat_penalty != 1.0 and req.repeat_last_n > 0
                       else 0)
                recent = _recent_window([req.prompt + req.out_tokens], win,
                                        self.device) if win else None
                tok = int(sample_token(
                    self._last_logits[i:i + 1], self._gen, req.temperature,
                    req.top_k, req.top_p,
                    req.repeat_penalty if win else 1.0, recent)[0, 0])
            self._emit(req, tok)
            toks[i, 0] = tok
            if _stopped(req) or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
        if any(s_ is not None and s_.want_logprobs for s_ in self.slots):
            lps = torch.gather(
                torch.log_softmax(self._last_logits, dim=-1), 1,
                torch.from_numpy(toks).long().to(self.device)).cpu().numpy()
            for i, req in enumerate(self.slots):
                if req is not None and req.want_logprobs and \
                        len(req.out_logprobs) < len(req.out_tokens):
                    req.out_logprobs.append(float(lps[i, 0]))

        # host-side length bucket: attention reads only the live prefix
        live = [len(s.prompt) + len(s.out_tokens) + 1
                for s in self.slots if s is not None]
        t_eff = length_bucket(min(max(live, default=1), self.max_len),
                              self.max_len, base=64)
        self._last_logits = self._step(self._upload(torch.from_numpy(toks)),
                                       self._active(), t_eff)
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                self._finish_slot(req, i)
        return True

    def run(self):
        """Drain all pending and live requests; returns the finished ones
        by id."""
        while self.pending or any(s is not None for s in self.slots):
            self.step_once()
        out, self.finished = self.finished, []
        return sorted(out, key=lambda r: r.id)
