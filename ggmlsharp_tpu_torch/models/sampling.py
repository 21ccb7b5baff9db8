"""Decode loops: prefill, then single-token steps over a KV cache, with
greedy or llama.cpp-style sampling (port of
ggmlsharp_tpu/models/sampling.py:16-164).

Works with any model module exposing
forward(params, cfg, tokens, cache, positions, prefix_bound=...). The JAX
package jits the prefill and the decode step with ``t_eff`` static and the
cache donated; here, on the card, each is a ``captured.CapturedStep``: one
CUDA graph a static key (a prompt length and ``t_eff`` for the prefill, a
length bucket for the step). ``generate`` and ``make_decode_fns``' prefill
take theirs from the graph cache (``captured.entry``): one entry a
(forward, cfg, parameter tree, settings, cache spec), whose graphs read the
entry's home cache; a call copies the caller's live rows in, runs there
and copies the rows back (the counterpart of donation), so a second call
with a new cache of the same spec captures nothing. ``make_decode_fns``'
step and ``make_greedy_step``, called a step at a time, read the caller's
own cache: one graph a ``t_eff`` for each (parameter tree, cache) pair,
nothing copied a step. Called with ``t_eff=None`` (JAX's in-graph
``lax.switch``, one executable), the step, the greedy step and the prefill
(one a prompt length) are each ONE parent graph
(``captured.CapturedStep.switch``): a selector kernel reads the cache's
``length`` on the device and runs the body captured for that bucket, so a
run across buckets replays one graph and makes no host read. A step writes
the cache's new length in place (``copy_``), so the ``KVCache`` object and
every buffer address stay fixed. On the CPU the same objects run eagerly;
inside ``captured.disabled()`` and for a tensor-parallel tree over gloo
(whose collectives go through the host; an NCCL tree is captured,
``common.capturable``) everything runs eagerly on the caller's cache, a
``None`` bound read on the host. ``generate`` tracks the live-prefix bound
on the host as in the JAX package. Sampling (``torch.multinomial``)
and the repeat-penalty window stay outside the graph and read its logits.
A ``torch.Generator`` takes the place of a JAX key: the two draw different
numbers from one seed, so sampled (temperature > 0) tokens are compared by
distribution, not value. ``generate_scan``, the TPU ``while_loop``
formulation, is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import NEG_INF
from ..kernels.graph_switch import bucket_bound, host_buckets
from . import captured
from .captured import CapturedStep, PerObjects
from .common import _chunk_buckets, capturable


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
    return tuple(t.data_ptr() for t in captured.buffers(cache))


def _prefill_body(forward, cfg, params, cache):
    """The prefill over ``cache`` as a step: (tokens [B, S], S=, t_eff=) ->
    last logits [B, V], the rows and the cache's length written in place
    (S static: one graph a prompt length)."""

    def prefill(tokens, S, t_eff):
        positions = cache.length[:, None] + torch.arange(
            S, dtype=torch.int32, device=tokens.device)[None, :]
        logits, out = forward(params, cfg, tokens, cache, positions,
                              prefix_bound=t_eff)
        cache.length.copy_(out.length)
        return logits[:, -1, :]

    return prefill


def _step_body(forward, cfg, params, cache, greedy: bool):
    """The decode step over ``cache``: (token [B, 1], t_eff=) -> logits
    [B, V] (greedy: the argmax, int32 [B, 1]), the row and the length
    written in place."""

    def step(token, t_eff):
        positions = cache.length[:, None]
        logits, out = forward(params, cfg, token, cache, positions,
                              prefix_bound=t_eff)
        cache.length.copy_(out.length)
        logits = logits[:, -1, :]
        if greedy:
            return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        return logits

    return step


class _StepGraphs:
    """The decode step of one model as a CapturedStep for the (parameter
    tree, cache) pair it was last called with (captured.PerObjects);
    another pair gets a new one. A tensor-parallel tree over gloo gets the
    step itself: it runs eagerly."""

    def __init__(self, forward, cfg, greedy: bool):
        # made by a closure, not a bound method: no reference cycle holds a
        # dropped object's graphs until a collection
        def make(params, cache):
            step = _step_body(forward, cfg, params, cache, greedy)
            if not capturable(params):
                return step
            return CapturedStep(step, state=(cache.length,))

        self._held = PerObjects(make)

    def __call__(self, params, cache):
        return self._held((params, cache), _addresses(cache))


def _decode_entry(forward, cfg, params, cache):
    """The graph cache's entry for a decode loop of ``forward`` over a cache
    of ``cache``'s spec, None where the loop runs eagerly on the caller's
    cache (inside captured.disabled(), for a tensor-parallel tree over
    gloo). Its
    home cache is ``homes[0]``; ``_prefill_of`` and ``_step_of`` give its
    CapturedSteps."""
    if captured.is_disabled() or not capturable(params):
        return None
    return captured.entry(("decode", forward, cfg), (params,), (cache,))


def _prefill_of(e, forward, cfg, params, which: int = 0):
    """Entry ``e``'s captured prefill over its home cache ``which``."""
    return e.step(("prefill", which), lambda *homes: CapturedStep(
        _prefill_body(forward, cfg, params, homes[which]),
        state=(homes[which].length,), pool=e.pool))


def _step_of(e, forward, cfg, params):
    """Entry ``e``'s captured decode step (logits) over its home cache."""
    return e.step("step", lambda home: CapturedStep(
        _step_body(forward, cfg, params, home, greedy=False),
        state=(home.length,), pool=e.pool))


def length_switch(name: str, cache, add: int):
    """The Bound of a ``t_eff=None`` call that writes ``add`` rows a slot:
    the bucket of max(``cache.length``) + add among ``_chunk_buckets``,
    chosen on the device (kernels.graph_switch)."""
    return bucket_bound(name, cache.length, add,
                        _chunk_buckets(cache.max_len))


def switched(step, bounds, *inputs, **key):
    """``step`` (a CapturedStep, or a step run eagerly) at the buckets the
    bounds select: a CapturedStep's in-graph switch, else the buckets read
    on the host."""
    if isinstance(step, CapturedStep):
        return step.switch(bounds, *inputs, **key)
    return step(*inputs, **key, **host_buckets(bounds))


def _step_call(step, token, cache, t_eff):
    """One decode step: the graph of ``t_eff``, or (None) the in-graph
    switch over the cache's buckets."""
    if t_eff is not None:
        return step(token, t_eff=t_eff)
    return switched(step, (length_switch("t_eff", cache, 1),), token)


def make_decode_fns(forward, cfg):
    """Returns (prefill, step).

    prefill(params, tokens [B, S], cache, t_eff=None) -> (last logits [B, V], cache)
    step(params, token [B, 1], cache, t_eff=None) -> (logits [B, V], cache)

    Both update ``cache`` in place (its rows and its length) and return it.
    On the card the prefill replays the graph cache's graph for (S,
    ``t_eff``) over the entry's home cache, the caller's live rows copied
    in and out (the longest live prefix, n0, is read on the host for that
    copy, as the graph cache does for every call); the step replays one
    graph a ``t_eff`` over the caller's own cache. ``t_eff=None`` (JAX's
    one executable): the prefill is one parent graph a prompt length and
    the step one parent graph, each picking its bucket on the device
    (``switched``); the step then makes no host read."""

    def prefill(params, tokens, cache, t_eff=None):
        S = tokens.shape[1]
        e = _decode_entry(forward, cfg, params, cache)
        if e is None:
            return _prefill_body(forward, cfg, params, cache)(
                tokens, S=S, t_eff=t_eff), cache
        n0 = int(cache.length.max())
        home = e.homes[0]
        captured.copy_rows(home, cache, n0)
        graph = _prefill_of(e, forward, cfg, params)
        # a clone: the graph's logits buffer is rewritten by its next replay
        if t_eff is None:
            logits = graph.switch((length_switch("t_eff", home, S),), tokens,
                                  S=S).clone()
        else:
            logits = graph(tokens, S=S, t_eff=t_eff).clone()
        captured.copy_rows(cache, home, n0 + S)
        return logits, cache

    graphs = _StepGraphs(forward, cfg, greedy=False)

    def step(params, token, cache, t_eff=None):
        # a clone: the graph's logits buffer is rewritten by its next replay
        return _step_call(graphs(params, cache), token, cache,
                          t_eff).clone(), cache

    return prefill, step


def make_greedy_step(forward, cfg):
    """A decode step that also takes the argmax: (params, token [B, 1],
    cache, t_eff=None) -> (next token int32 [B, 1], cache), the cache
    updated in place; on the card one captured graph a ``t_eff``, and for
    ``t_eff=None`` one parent graph that picks the bucket on the device."""
    graphs = _StepGraphs(forward, cfg, greedy=True)

    def greedy_step(params, token, cache, t_eff=None):
        return _step_call(graphs(params, cache), token, cache,
                          t_eff).clone(), cache

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
    that device for temperature > 0. On the card the prefill and the steps
    replay the graph cache's graphs over its home cache, the caller's live
    rows copied in before and back after. Returns (tokens int32
    [B, n_tokens], cache), the cache updated in place."""
    T = cache.max_len
    S = prompt.shape[1]
    n0 = int(cache.length.max())  # one small fetch up front
    cur = S + n0  # host-tracked upper bound on the live prefix
    e = _decode_entry(forward, cfg, params, cache)
    if e is None:
        run = cache
        prefill = _prefill_body(forward, cfg, params, run)
        step = _step_body(forward, cfg, params, run, greedy=False)
    else:
        run = e.homes[0]
        captured.copy_rows(run, cache, n0)
        prefill = _prefill_of(e, forward, cfg, params)
        step = _step_of(e, forward, cfg, params)
    # on the card the logits are a graph's buffer, sampled from before the
    # next replay rewrites it
    logits = prefill(prompt, S=S, t_eff=length_bucket(cur, T))
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
    if e is not None:
        captured.copy_rows(cache, run, cur)
    return torch.cat(out, dim=1), cache
