"""Speculative decoding (port of ggmlsharp_tpu/models/speculative.py): a
draft model proposes k tokens a round, the target verifies all of them in
ONE batched forward, and the longest matching prefix, plus the target's own
correction or bonus token, is emitted. Greedy-exact: the tokens are plain
greedy decode's on the target wherever the target's verify route computes
the function of its single-token route; each target forward reads the
weights once for up to k+1 tokens.

The JAX package jits a round into one executable with ``t_eff`` / ``d_eff``
static and its caches donated; here a round is a ``captured.CapturedStep``:
on the card one CUDA graph a (``t_eff``, ``d_eff``). With both ``None``
(JAX's in-graph switch, one executable) the round is one parent graph
whose selector reads both caches' lengths on the device and runs the body
captured for that (target bucket, draft bucket) pair
(``CapturedStep.switch``): no host read. Called a round at a
time (``make_spec_round``, ``make_spec_round_sampled``), it has one for
each (target tree, draft tree, target cache, draft cache[, generator]).
``speculative_generate`` takes its rounds and both prefills from the graph
cache (``captured.entry``): one entry a (forwards, configs, trees,
settings, cache specs), whose graphs read the entry's two home caches; a
call copies the caller's live rows in and back, so a second call with new
caches of the same specs captures nothing; a sampled call copies its
generator's state into the entry's generator, which the graphs register,
and back. The round writes both caches in place: the K/V rows (kv_cache)
and each ``length`` with ``copy_``, so it returns its input cache objects
and every buffer address stays fixed; its tokens, ``n_emit`` and next seed
are the graph's buffers, which the next round overwrites (read or clone
them first). On the CPU the same objects run eagerly; inside
``captured.disabled()`` and for a tensor-parallel tree over gloo
(``common.capturable``) everything runs eagerly on the caller's caches, a
``None`` bound read on the host. Rollback is O(1):
attention masks by per-slot position, so rejecting drafts only resets
``length``, and the stale rows past it are overwritten by the next round's
writes at those positions. Every reader bounds itself by positions (einsum
mask, flash and attn_decode npast, the whole-block kernels' npast), never
by what the buffer holds.

Invariants at a round's start (h = index of the newest emitted token a):
  * the target cache holds the K/V of history[0:h]      (length == h)
  * the draft cache holds the K/V of history[0:h-1]     (length == h-1)
  * seed == [history[h-1], history[h]]
The 2-token draft seed keeps every round the same shape even when all k
drafts are accepted and the draft cache is a full token behind the bonus
token.

Sampling: ``torch.Generator`` draws in place of the JAX package's
``fold_in`` keys, so a sampled stream equals the JAX one in distribution,
not token for token. A sampled round draws, in this order: one categorical
draw a draft token (k of them, all slots at once; ``_draw``), one
``rand((B, k))`` for the acceptance tests, one categorical draw of the
residual; ``speculative_generate`` first samples a0 with ``sample_token``.
On the card the generator is registered with the round's graphs, so each
replay draws what the eager round would draw from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import captured
from . import kv_cache as kvc
from .captured import CapturedStep, PerObjects
from .common import capturable
from .sampling import (_addresses, _prefill_body, _prefill_of, length_bucket,
                       length_switch, sample_token, switched)


def set_length(cache: kvc.KVCache, length) -> kvc.KVCache:
    """Write per-slot ``length`` into the cache's own length buffer
    (speculative rollback, in place) and return the cache. Rows past it
    stay in the buffers, masked out of attention, until writes at those
    positions overwrite them."""
    cache.length.copy_(length)
    return cache


def _check_vocab(t_cfg, d_cfg):
    if t_cfg.n_vocab != d_cfg.n_vocab:
        raise ValueError(
            f"draft/target vocab mismatch: {d_cfg.n_vocab} vs {t_cfg.n_vocab}")


def _accept(x, d, gm, m, t_cache, d_cache, k):
    """The round's tail, shared by both rounds: emitted [B, k+1] (the m
    accepted drafts, then the correction or bonus token gm [B, 1], then -1),
    n_emit = m + 1, both caches rolled back and the next seed. Lengths are
    clamped to [0, T - (k+1)]: every slot runs the round, idle and chunking
    slots of an engine included, and their lengths drift; the upper clamp
    keeps the next round's k+1 in-place writes inside the slot's rows, where
    the JAX package's dynamic_update_slice clamps its writes alike. A live
    slot never reaches either bound (the callers' headroom checks)."""
    B = x.shape[0]
    dev = x.device
    m = m.long()
    idx = torch.arange(k + 1, device=dev)[None]
    gm = gm.to(d.dtype)
    d_pad = torch.cat([d, torch.zeros((B, 1), dtype=d.dtype, device=dev)], 1)
    emitted = torch.where(idx < m[:, None], d_pad,
                          torch.where(idx == m[:, None], gm,
                                      torch.full_like(d_pad, -1)))
    n_emit = (m + 1).to(torch.int32)
    top = t_cache.max_len - (k + 1)
    h_new = (t_cache.length - (k + 1) + n_emit).clamp(0, top)
    set_length(t_cache, h_new)
    set_length(d_cache, (h_new - 1).clamp(min=0))
    seed_next = torch.cat([torch.take_along_dim(x, m[:, None], dim=1), gm], 1)
    return emitted.to(torch.int32), n_emit, seed_next.to(torch.int32)


def _forward_in_place(forward, params, cfg, tokens, cache, positions,
                      **kw):
    """forward over ``cache``, its new length copied into the cache's own
    buffer: the logits [B, S, V]."""
    logits, out = forward(params, cfg, tokens, cache, positions, **kw)
    cache.length.copy_(out.length)
    return logits


def _round_call(graphs, t_cache, d_cache, k, t_eff, d_eff, *inputs):
    """One round at t_eff and d_eff; a None bound is the in-graph switch's
    (the bucket of the round's longest live prefix, k + 1 rows past the
    longest length: the bound its last forward of that model reaches),
    chosen on the device."""
    key, bounds = {}, []
    for name, cache, eff in (("t_eff", t_cache, t_eff),
                             ("d_eff", d_cache, d_eff)):
        if eff is None:
            bounds.append(length_switch(name, cache, k + 1))
        else:
            key[name] = eff
    if not bounds:
        return graphs(*inputs, **key)
    return switched(graphs, bounds, *inputs, **key)


def _round_graphs(body, sampled):
    """The round ``body(t_params, d_params, t_cache, d_cache, rng, *inputs,
    t_eff=, d_eff=)`` as a CapturedStep for the objects it was last called
    with (captured.PerObjects): both lengths its state, the generator (for
    the sampled round) registered. A tensor-parallel tree over gloo gets
    the body itself: it runs eagerly."""

    def make(tp, dp, tc, dc, rng):
        def run(*inputs, t_eff, d_eff):
            return body(tp, dp, tc, dc, rng, *inputs, t_eff=t_eff,
                        d_eff=d_eff)

        if not capturable(tp, dp):
            return run
        return CapturedStep(run, state=(tc.length, dc.length),
                            generators=(rng,) if sampled else ())

    held = PerObjects(make)

    def graphs(tp, dp, tc, dc, rng=None):
        return held((tp, dp, tc, dc, rng),
                    _addresses(tc) + _addresses(dc))

    return graphs


def _entry_graphs(e, k: int):
    """The rounds of graph cache entry ``e`` (over its two home caches and
    its own generator), in ``_round_graphs``' form: one CapturedStep a k
    and kind, made at the first call."""

    def held(body, sampled):
        def graphs(tp, dp, tc, dc, rng=None):
            def make(htc, hdc):
                def run(*inputs, t_eff, d_eff):
                    return body(tp, dp, htc, hdc, rng, *inputs, t_eff=t_eff,
                                d_eff=d_eff)

                return CapturedStep(run, state=(htc.length, hdc.length),
                                    generators=(rng,) if sampled else (),
                                    pool=e.pool)

            return e.step(("round", k, sampled), make)

        return graphs

    return held


def make_spec_round(t_forward, t_cfg, d_forward, d_cfg, k: int,
                    held=None):
    """The greedy speculative round.

    spec_round(t_params, d_params, t_cache, d_cache, seed [B, 2],
               t_eff=, d_eff=) ->
        (emitted int32 [B, k+1] (-1 padded), n_emit int32 [B],
         t_cache, d_cache, seed' [B, 2])

    Emits between 1 (no draft accepted: the target's own next token) and
    k+1 (all accepted and the bonus token) tokens a slot a round. Both
    caches are written in place and returned; emitted, n_emit and seed' are
    the round's buffers, rewritten by its next call. On the card one
    captured graph a (t_eff, d_eff); with both None one parent graph that
    picks the buckets on the device. Both forwards must take ``cached_prefix=`` (gpt2, llama and
    gptj do): the verify and the seed prefill run at positions > 0, so a
    flat cache's attention must read the cache's live prefix. ``held``:
    where the round's CapturedStep comes from, (body, sampled) ->
    graphs(t_params, d_params, t_cache, d_cache, rng) (default: one for the
    objects it was last called with; speculative_generate passes its graph
    cache entry's)."""
    _check_vocab(t_cfg, d_cfg)

    def body(t_params, d_params, t_cache, d_cache, _rng, seed, t_eff,
             d_eff):
        dev = seed.device
        # draft chain: the 2-token seed prefill, then k - 1 greedy steps
        pos = d_cache.length[:, None] + torch.arange(
            2, dtype=torch.int32, device=dev)[None]
        lg = _forward_in_place(d_forward, d_params, d_cfg, seed, d_cache,
                               pos, prefix_bound=d_eff, cached_prefix=True)
        tok = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
        drafts = [tok]
        for _ in range(k - 1):
            lg = _forward_in_place(d_forward, d_params, d_cfg, tok, d_cache,
                                   d_cache.length[:, None],
                                   prefix_bound=d_eff)
            tok = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
            drafts.append(tok)
        d = torch.cat(drafts, dim=1)  # [B, k]

        # verify: ONE target forward over [a, d_1..d_k]
        x = torch.cat([seed[:, 1:2], d], dim=1)  # [B, k+1]
        pos = t_cache.length[:, None] + torch.arange(
            k + 1, dtype=torch.int32, device=dev)[None]
        logits = _forward_in_place(t_forward, t_params, t_cfg, x, t_cache,
                                   pos, prefix_bound=t_eff,
                                   cached_prefix=True)
        g = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]

        # accept the longest matching prefix, then correct or add the bonus
        match = (g[:, :-1] == d).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1).long()  # [B] in 0..k
        return _accept(x, d, torch.take_along_dim(g, m[:, None], dim=1), m,
                       t_cache, d_cache, k)

    graphs = (held or _round_graphs)(body, sampled=False)

    @torch.no_grad()
    def spec_round(t_params, d_params, t_cache, d_cache, seed,
                   t_eff=None, d_eff=None):
        emitted, n_emit, seed_next = _round_call(
            graphs(t_params, d_params, t_cache, d_cache), t_cache, d_cache,
            k, t_eff, d_eff, seed)
        return emitted, n_emit, t_cache, d_cache, seed_next

    return spec_round


@torch.inference_mode()
def speculative_generate(t_forward, t_cfg, t_params,
                         d_forward, d_cfg, d_params,
                         prompt, t_cache, d_cache,
                         n_tokens: int, k: int = 4,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0, rng=None):
    """Speculative decode. prompt: int [B, S] (S >= 1) on the caches'
    device; both caches fresh (length 0) with max_len >= S + n_tokens + k + 2.
    temperature <= 0 (the default): greedy-exact, the target's own greedy
    decode. temperature > 0 (needs ``rng``, a torch.Generator on the
    device): rejection-sampled speculative sampling, distributed as sampling
    the target alone under the same temperature, top_k and top_p. On the
    card both prefills and every round replay the graph cache's graphs over
    its home caches, the caller's live rows copied in before and back
    after (both caches are updated in place). Returns (tokens int32
    [B, n_tokens] on the prompt's device, the mean tokens emitted a round a
    slot, in [1, k+1]: the amortisation of a target forward actually
    reached)."""
    B, S = prompt.shape
    sampled = temperature > 0.0
    if sampled and rng is None:
        raise ValueError("temperature > 0 requires an rng generator")
    need = S + n_tokens + k + 2
    for c, who in ((t_cache, "target"), (d_cache, "draft")):
        if c.max_len < need:
            raise ValueError(
                f"{who} cache max_len {c.max_len} < {need} needed for "
                f"S={S} + n_tokens={n_tokens} + k={k} headroom")

    dev = prompt.device
    e = None
    if not captured.is_disabled() and capturable(t_params, d_params):
        e = captured.entry(("speculative", t_forward, t_cfg, d_forward,
                            d_cfg), (t_params, d_params), (t_cache, d_cache))
    if e is None:  # eagerly, on the caller's caches and generator
        tc, dc, held, draws = t_cache, d_cache, None, rng
        t_prefill = _prefill_body(t_forward, t_cfg, t_params, tc)
        d_prefill = _prefill_body(d_forward, d_cfg, d_params, dc)
    else:
        tc, dc = e.homes
        n0 = torch.stack([t_cache.length.max(), d_cache.length.max()])
        n0 = n0.tolist()
        captured.copy_rows(tc, t_cache, n0[0])
        captured.copy_rows(dc, d_cache, n0[1])
        held = _entry_graphs(e, k)
        draws = e.own_generator(rng) if sampled else None
        t_prefill = _prefill_of(e, t_forward, t_cfg, t_params, 0)
        d_prefill = _prefill_of(e, d_forward, d_cfg, d_params, 1)
    if sampled:
        round_s = make_spec_round_sampled(t_forward, t_cfg, d_forward, d_cfg,
                                          k, held=held)
        tv = torch.full((B,), temperature, dtype=torch.float32, device=dev)
        kv_ = torch.full((B,), top_k, dtype=torch.int32, device=dev)
        pv = torch.full((B,), top_p, dtype=torch.float32, device=dev)

        def spec_round(tp, dp, tc, dc, seed, t_eff=None, d_eff=None):
            return round_s(tp, dp, tc, dc, seed, draws, tv, kv_, pv,
                           t_eff=t_eff, d_eff=d_eff)
    else:
        spec_round = make_spec_round(t_forward, t_cfg, d_forward, d_cfg, k,
                                     held=held)

    logits = t_prefill(prompt, S=S, t_eff=length_bucket(S, tc.max_len))
    a0 = sample_token(logits, rng, temperature, top_k, top_p) if sampled \
        else torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    if S > 1:  # the draft holds history[0:S-1]; prompt[-1] rides the seed
        d_prefill(prompt[:, :-1], S=S - 1,
                  t_eff=length_bucket(S - 1, dc.max_len))
    seed = torch.cat([prompt[:, -1:].to(torch.int32), a0], dim=1)
    if sampled and draws is not rng:  # the rounds draw where rng would
        draws.set_state(rng.get_state())

    a0_host = a0.cpu().numpy()
    out = [[int(a0_host[b, 0])] for b in range(B)]
    h_max = S  # an upper bound on any slot's history length
    rounds = emitted_total = 0
    while min(len(o) for o in out) < n_tokens:
        t_eff = length_bucket(h_max + k + 2, tc.max_len)
        d_eff = length_bucket(h_max + k + 2, dc.max_len)
        emitted, n_emit, tc, dc, seed = spec_round(
            t_params, d_params, tc, dc, seed, t_eff=t_eff, d_eff=d_eff)
        # ONE fetch a round: the tokens and their count side by side
        both = torch.cat([emitted, n_emit[:, None]], dim=1).cpu().numpy()
        em, ne = both[:, :-1], both[:, -1]
        for b in range(B):
            out[b].extend(int(t) for t in em[b, :ne[b]])
        h_max += int(ne.max())
        rounds += 1
        emitted_total += int(ne.sum())
    if e is not None:  # every row a round may have written, and the lengths
        captured.copy_rows(t_cache, tc, h_max + k + 2)
        captured.copy_rows(d_cache, dc, h_max + k + 2)
        if sampled:
            rng.set_state(draws.get_state())
    toks = np.stack([o[:n_tokens] for o in out]).astype(np.int32)
    return torch.from_numpy(toks).to(dev), emitted_total / max(1, rounds * B)


def _mod_probs(logits, temp, top_k, top_p):
    """The per-slot sampling distribution [B, V] that sample_token draws
    from, under per-slot temperature / top-k / top-p tensors [B]. temp <= 0
    gives the one-hot argmax, so greedy slots ride the sampled round and
    rejection sampling reduces to greedy prefix matching for them."""
    V = logits.shape[-1]
    greedy = temp <= 0.0
    l = logits / torch.where(greedy, torch.ones_like(temp), temp)[:, None]
    order = torch.argsort(-l, dim=-1, stable=True)
    sl = torch.take_along_dim(l, order, dim=-1)
    keff = torch.clamp(torch.where(top_k > 0, top_k, V), 1, V)[:, None]
    kth = torch.take_along_dim(sl, (keff - 1).long(), dim=-1)  # [B, 1]
    sl = sl.masked_fill(sl < kth, float("-inf"))
    # nucleus: the smallest prefix of the sorted probabilities reaching top_p
    ps = torch.softmax(sl, dim=-1)
    keep_sorted = (torch.cumsum(ps, dim=-1) - ps) < top_p[:, None]
    inv = torch.argsort(order, dim=-1)
    keep = torch.take_along_dim(keep_sorted, inv, dim=-1)
    l = l.masked_fill(~(keep & (l >= kth)), float("-inf"))
    p = torch.softmax(l, dim=-1)
    # the argmax's one-hot row (a scatter: one_hot checks its classes on
    # the host on the CPU)
    g = torch.zeros_like(p).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.where(greedy[:, None], g, p)


def _draw(probs, rng):
    """One categorical draw a row of a [B, V] weight batch: int32 [B]. The
    draw ``torch.multinomial(probs, 1, generator=rng)`` makes (ATen's
    one-sample route: exponential noise q, then the argmax of probs / q;
    the same numbers from the same generator state), without the host-side
    checks of the weights that it makes first, which a graph cannot."""
    q = torch.empty_like(probs).exponential_(1.0, generator=rng)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def make_spec_round_sampled(t_forward, t_cfg, d_forward, d_cfg, k: int,
                            held=None):
    """The sampled speculative round: standard rejection sampling
    (Leviathan et al.; Chen et al.). The draft SAMPLES k tokens from its
    modified distributions q_i; the target computes p_i in one forward;
    token i is accepted with probability min(1, p_i[d_i] / q_i[d_i]); the
    first rejection emits a sample of norm(max(p_i - q_i, 0)), and a fully
    accepted chain a bonus sample of p_{k+1}. The stream is distributed as
    sampling the target alone; temp <= 0 slots degenerate to the greedy
    round (one-hot distributions: acceptance is argmax match).

    spec_round(t_params, d_params, t_cache, d_cache, seed [B, 2], rng,
               temp [B], top_k [B], top_p [B], t_eff=, d_eff=) ->
        (emitted [B, k+1] (-1 padded), n_emit [B], t_cache, d_cache,
         seed' [B, 2])

    rng: a torch.Generator on the device, drawn in the order the module
    docstring gives. ``held`` as make_spec_round's."""
    _check_vocab(t_cfg, d_cfg)

    def body(t_params, d_params, t_cache, d_cache, rng, seed, temp, top_k,
             top_p, t_eff, d_eff):
        B = seed.shape[0]
        dev = seed.device
        # draft chain: sample each proposal, keep its q_i
        pos = d_cache.length[:, None] + torch.arange(
            2, dtype=torch.int32, device=dev)[None]
        lg = _forward_in_place(d_forward, d_params, d_cfg, seed, d_cache,
                               pos, prefix_bound=d_eff, cached_prefix=True)
        qs, drafts = [], []
        tok = None
        for i in range(k):
            if i > 0:
                lg = _forward_in_place(d_forward, d_params, d_cfg, tok,
                                       d_cache, d_cache.length[:, None],
                                       prefix_bound=d_eff)
            q = _mod_probs(lg[:, -1, :].to(torch.float32), temp, top_k,
                           top_p)
            tok = _draw(q, rng)[:, None]
            qs.append(q)
            drafts.append(tok)
        d = torch.cat(drafts, dim=1)       # [B, k]
        q_all = torch.stack(qs, dim=1)     # [B, k, V]

        # verify: ONE target forward over [a, d_1..d_k]
        x = torch.cat([seed[:, 1:2], d], dim=1)
        pos = t_cache.length[:, None] + torch.arange(
            k + 1, dtype=torch.int32, device=dev)[None]
        logits = _forward_in_place(t_forward, t_params, t_cfg, x, t_cache,
                                   pos, prefix_bound=t_eff,
                                   cached_prefix=True)
        V = logits.shape[-1]

        def per_row(v):  # [B] -> [B * (k+1)], each slot's value k+1 times
            return v[:, None].expand(B, k + 1).reshape(-1)

        p_all = _mod_probs(
            logits.to(torch.float32).reshape(B * (k + 1), V),
            per_row(temp), per_row(top_k), per_row(top_p)
        ).reshape(B, k + 1, V)

        # rejection-sampling accept and correct
        dl = d.long()[..., None]
        p_d = torch.take_along_dim(p_all[:, :k, :], dl, dim=-1)[..., 0]
        q_d = torch.take_along_dim(q_all, dl, dim=-1)[..., 0]
        u = torch.rand((B, k), generator=rng, device=dev)
        accept = (u * q_d < p_d).to(torch.int32)
        m = torch.cumprod(accept, dim=1).sum(dim=1)  # [B] in 0..k
        # the residual at the first rejection (or the bonus row when m == k,
        # where q is zero-padded so the residual IS p_{k+1})
        q_pad = torch.cat([q_all, q_all.new_zeros((B, 1, V))], dim=1)
        mi = m.long()[:, None, None].expand(B, 1, V)
        p_m = torch.take_along_dim(p_all, mi, dim=1)[:, 0, :]
        q_m = torch.take_along_dim(q_pad, mi, dim=1)[:, 0, :]
        res = torch.clamp(p_m - q_m, min=0.0)
        # a numerically empty residual (p == q): sample p itself
        res = torch.where(res.sum(-1, keepdim=True) > 0, res, p_m)
        return _accept(x, d, _draw(res, rng)[:, None], m, t_cache, d_cache,
                       k)

    graphs = (held or _round_graphs)(body, sampled=True)

    @torch.no_grad()
    def spec_round(t_params, d_params, t_cache, d_cache, seed, rng,
                   temp, top_k, top_p, t_eff=None, d_eff=None):
        emitted, n_emit, seed_next = _round_call(
            graphs(t_params, d_params, t_cache, d_cache, rng), t_cache,
            d_cache, k, t_eff, d_eff, seed, temp, top_k, top_p)
        return emitted, n_emit, t_cache, d_cache, seed_next

    return spec_round
