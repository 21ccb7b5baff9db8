"""Decode loops: prefill, then single-token steps over a KV cache, with
greedy or llama.cpp-style sampling (port of
ggmlsharp_tpu/models/sampling.py:16-164).

Works with any model module exposing
forward(params, cfg, tokens, cache, positions, prefix_bound=...). The JAX
package jits the decode step with ``t_eff`` static; here, on the card, the
step is a ``captured.CapturedStep``: one CUDA graph a length bucket, for
each parameter tree and cache (a graph reads both at the addresses they had
at capture, so a new cache, as each ``generate`` call is given, is captured
anew). The step writes the cache's new length in place (``copy_``), so the
``KVCache`` object and every buffer address stay fixed. On the CPU, inside
``captured.disabled()`` and for a tensor-parallel tree (whose collectives
go through the host) the step runs eagerly. The prefill stays eager (one
call a request; its shapes vary). The live-prefix bound is tracked on the
host as in the JAX package. Sampling (``torch.multinomial``) and the
repeat-penalty window stay outside the graph and read its logits. A
``torch.Generator`` takes the place of a JAX key: the two draw different
numbers from one seed, so sampled (temperature > 0) tokens are compared
by distribution, not value. ``generate_scan``, the TPU ``while_loop``
formulation, is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import NEG_INF
from .captured import CapturedStep, PerObjects
from .common import _chunk_buckets, tp_axis


def length_bucket(n: int, max_len: int, base: int = 256) -> int:
    """Smallest geometric bucket >= n (common._chunk_buckets): attention
    reads only that many cache rows. The serving engine uses base 64."""
    for b in _chunk_buckets(max_len, base=base):
        if n <= b:
            return b
    return max_len


def _addresses(cache) -> tuple:
    """The addresses of every buffer of ``cache``: what a captured step
    reads and writes."""
    bufs = (cache.length, *cache.k, *cache.v, *(cache.k_scale or ()),
            *(cache.v_scale or ()))
    return tuple(t.data_ptr() for t in bufs)


class _StepGraphs:
    """The decode step of one model as a CapturedStep for the (parameter
    tree, cache) pair it was last called with (captured.PerObjects);
    another pair gets a new one. A tensor-parallel tree gets the step
    itself: it runs eagerly."""

    def __init__(self, forward, cfg, greedy: bool):
        self.forward, self.cfg, self.greedy = forward, cfg, greedy
        self._held = PerObjects(self._make)

    def _make(self, params, cache):
        forward, cfg, greedy = self.forward, self.cfg, self.greedy

        def step(token, t_eff):
            positions = cache.length[:, None]
            logits, out = forward(params, cfg, token, cache, positions,
                                  prefix_bound=t_eff)
            cache.length.copy_(out.length)
            logits = logits[:, -1, :]
            if greedy:
                return torch.argmax(logits, dim=-1,
                                    keepdim=True).to(torch.int32)
            return logits

        if tp_axis(params) is not None:
            return step
        return CapturedStep(step, state=(cache.length,))

    def __call__(self, params, cache):
        return self._held((params, cache), _addresses(cache))


def _bound(cache, t_eff):
    """t_eff, or (None) the bucket of the longest live prefix after this
    step, which the forward would compute from the device (read here,
    outside the graph)."""
    if t_eff is not None:
        return t_eff
    return length_bucket(int(cache.length.max()) + 1, cache.max_len)


def make_decode_fns(forward, cfg):
    """Returns (prefill, step).

    prefill(params, tokens [B, S], cache, t_eff=None) -> (last logits [B, V], cache)
    step(params, token [B, 1], cache, t_eff=None) -> (logits [B, V], cache)

    step updates ``cache`` in place (its rows and its length) and returns
    it; on the card it replays one captured graph a ``t_eff``."""

    def prefill(params, tokens, cache, t_eff=None):
        S = tokens.shape[1]
        positions = cache.length[:, None] + torch.arange(
            S, dtype=torch.int32, device=tokens.device)[None, :]
        logits, cache = forward(params, cfg, tokens, cache, positions,
                                prefix_bound=t_eff)
        return logits[:, -1, :], cache

    graphs = _StepGraphs(forward, cfg, greedy=False)

    def step(params, token, cache, t_eff=None):
        # a clone: the graph's logits buffer is rewritten by its next replay
        return graphs(params, cache)(token,
                                     t_eff=_bound(cache, t_eff)).clone(), cache

    return prefill, step


def make_greedy_step(forward, cfg):
    """A decode step that also takes the argmax: (params, token [B, 1],
    cache, t_eff=None) -> (next token int32 [B, 1], cache), the cache
    updated in place; on the card one captured graph a ``t_eff``."""
    graphs = _StepGraphs(forward, cfg, greedy=True)

    def greedy_step(params, token, cache, t_eff=None):
        return graphs(params, cache)(token,
                                     t_eff=_bound(cache, t_eff)).clone(), cache

    return greedy_step


def apply_repeat_penalty(logits, recent_tokens, penalty: float):
    """CTRL-style repetition penalty over the recent-token window
    (llama.cpp-era semantics: positive logits of seen tokens divide by
    ``penalty``, negative multiply). recent_tokens: int [B, N], -1 = pad."""
    V = logits.shape[-1]
    ids = recent_tokens.long().clamp(0, V - 1)
    valid = recent_tokens >= 0
    # count the valid hits of each token: a pad (-1, clipped to 0) adds 0
    hit = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device
                      ).scatter_add_(1, ids, valid.to(torch.int32)) > 0
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(hit, pen, logits)


def filter_logits(logits, temperature: float, top_k: int = 0,
                  top_p: float = 1.0):
    """Temperature, then top-k and nucleus top-p truncation: the logits
    that sample_token draws from (truncated entries are -1e30)."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                             logits)
    if top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        sl = torch.take_along_dim(logits, order, dim=-1)
        probs = torch.softmax(sl, dim=-1)
        # keep the smallest prefix whose mass reaches top_p (the first
        # token always survives: the exclusive cumsum is 0 there)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        sl = torch.where(keep, sl, torch.full_like(sl, NEG_INF))
        logits = torch.empty_like(sl).scatter_(-1, order, sl)
    return logits


def sample_token(logits, generator=None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 repeat_penalty: float = 1.0, recent_tokens=None):
    """logits [B, V] -> token int32 [B, 1]. The llama.cpp-era sampler
    stack: repetition penalty over ``recent_tokens``, top-k then nucleus
    top-p truncation, temperature sampling with ``generator``. temperature
    <= 0 is greedy argmax (over the penalized logits, so the penalty still
    steers greedy decode)."""
    if repeat_penalty != 1.0 and recent_tokens is not None:
        logits = apply_repeat_penalty(logits, recent_tokens, repeat_penalty)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def _recent_window(history, repeat_last_n: int, device=None):
    """The last ``repeat_last_n`` tokens of [B, S] host history, -1-padded
    on the left to a fixed width, as an int32 tensor on ``device``.
    repeat_last_n <= 0 means 'penalty off' (llama.cpp semantics): callers
    must not reach here with it."""
    if repeat_last_n <= 0:
        raise ValueError("repeat_last_n must be positive")
    history = np.asarray(history, np.int32)
    recent = history[:, -repeat_last_n:]
    if recent.shape[1] < repeat_last_n:
        pad = np.full((recent.shape[0], repeat_last_n - recent.shape[1]),
                      -1, np.int32)
        recent = np.concatenate([pad, recent], axis=1)
    return torch.from_numpy(recent).to(device or "cpu")


@torch.inference_mode()
def generate(forward, cfg, params, prompt, cache, n_tokens: int,
             temperature: float = 0.0, top_k: int = 0, rng=None,
             echo_logits: bool = False, top_p: float = 1.0,
             repeat_penalty: float = 1.0, repeat_last_n: int = 64):
    """Host-driven decode: prefill once, then n_tokens single-token steps.
    prompt: int [B, S] on the cache's device; rng: a torch.Generator on
    that device for temperature > 0. Returns (tokens int32 [B, n_tokens],
    cache)."""
    prefill, _ = make_decode_fns(forward, cfg)
    T = cache.max_len
    # host-tracked upper bound on the live prefix (one small fetch up front)
    cur = prompt.shape[1] + int(cache.length.max())
    logits, cache = prefill(params, prompt, cache, t_eff=length_bucket(cur, T))
    # the captured step of this tree and cache: its logits are the graph's
    # buffer, sampled from before the next replay rewrites it
    step = _StepGraphs(forward, cfg, greedy=False)(params, cache)
    penalize = repeat_penalty != 1.0 and repeat_last_n > 0
    history = prompt.cpu().numpy().astype(np.int32) if penalize else None
    out = []
    for _ in range(n_tokens):
        recent = _recent_window(history, repeat_last_n, prompt.device) \
            if penalize else None
        tok = sample_token(logits, rng, temperature, top_k, top_p,
                           repeat_penalty if penalize else 1.0, recent)
        out.append(tok)
        if penalize:
            history = np.concatenate([history, tok.cpu().numpy()], axis=1)
        cur += 1
        logits = step(tok, t_eff=length_bucket(cur, T))
    return torch.cat(out, dim=1), cache
