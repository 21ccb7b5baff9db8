"""Speculative decoding (port of ggmlsharp_tpu/models/speculative.py): a
draft model proposes k tokens a round, the target verifies all of them in
ONE batched forward, and the longest matching prefix, plus the target's own
correction or bonus token, is emitted. Greedy-exact: the tokens are plain
greedy decode's on the target wherever the target's verify route computes
the function of its single-token route; each target forward reads the
weights once for up to k+1 tokens.

The JAX package jits a round into one executable with its caches donated;
here a round runs eagerly, a forward at a time, and the caches are written in
place (kv_cache). Rollback is O(1): attention masks by per-slot position, so
rejecting drafts only resets ``length``, and the stale rows past it are
overwritten by the next round's writes at those positions. Every reader
bounds itself by positions (einsum mask, flash and attn_decode npast, the
whole-block kernels' npast), never by what the buffer holds.

Invariants at a round's start (h = index of the newest emitted token a):
  * the target cache holds the K/V of history[0:h]      (length == h)
  * the draft cache holds the K/V of history[0:h-1]     (length == h-1)
  * seed == [history[h-1], history[h]]
The 2-token draft seed keeps every round the same shape even when all k
drafts are accepted and the draft cache is a full token behind the bonus
token.

Sampling: ``torch.Generator`` draws in place of the JAX package's
``fold_in`` keys, so a sampled stream equals the JAX one in distribution,
not token for token. A sampled round draws, in this order: one
``multinomial`` a draft token (k of them, all slots at once), one
``rand((B, k))`` for the acceptance tests, one ``multinomial`` of the
residual; ``speculative_generate`` first samples a0 with ``sample_token``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kv_cache as kvc
from .sampling import length_bucket, make_decode_fns, sample_token


def set_length(cache: kvc.KVCache, length) -> kvc.KVCache:
    """A cache over the same buffers with per-slot ``length`` (speculative
    rollback). Rows past it stay in the buffers, masked out of attention,
    until writes at those positions overwrite them."""
    return kvc.KVCache(cache.k, cache.v, cache.k_scale, cache.v_scale,
                       length.to(torch.int32))


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
    t_cache = set_length(t_cache, h_new)
    d_cache = set_length(d_cache, (h_new - 1).clamp(min=0))
    seed_next = torch.cat([torch.take_along_dim(x, m[:, None], dim=1), gm], 1)
    return emitted.to(torch.int32), n_emit, t_cache, d_cache, \
        seed_next.to(torch.int32)


def make_spec_round(t_forward, t_cfg, d_forward, d_cfg, k: int):
    """The greedy speculative round.

    spec_round(t_params, d_params, t_cache, d_cache, seed [B, 2],
               t_eff=, d_eff=) ->
        (emitted int32 [B, k+1] (-1 padded), n_emit int32 [B],
         t_cache, d_cache, seed' [B, 2])

    Emits between 1 (no draft accepted: the target's own next token) and
    k+1 (all accepted and the bonus token) tokens a slot a round. Both
    forwards must take ``cached_prefix=`` (gpt2, llama and gptj do): the
    verify and the seed prefill run at positions > 0, so a flat cache's
    attention must read the cache's live prefix."""
    _check_vocab(t_cfg, d_cfg)

    @torch.no_grad()
    def spec_round(t_params, d_params, t_cache, d_cache, seed,
                   t_eff=None, d_eff=None):
        dev = seed.device
        # draft chain: the 2-token seed prefill, then k - 1 greedy steps
        pos = d_cache.length[:, None] + torch.arange(
            2, dtype=torch.int32, device=dev)[None]
        lg, d_cache = d_forward(d_params, d_cfg, seed, d_cache, pos,
                                prefix_bound=d_eff, cached_prefix=True)
        tok = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
        drafts = [tok]
        for _ in range(k - 1):
            lg, d_cache = d_forward(d_params, d_cfg, tok, d_cache,
                                    d_cache.length[:, None],
                                    prefix_bound=d_eff)
            tok = torch.argmax(lg[:, -1:, :], dim=-1).to(torch.int32)
            drafts.append(tok)
        d = torch.cat(drafts, dim=1)  # [B, k]

        # verify: ONE target forward over [a, d_1..d_k]
        x = torch.cat([seed[:, 1:2], d], dim=1)  # [B, k+1]
        pos = t_cache.length[:, None] + torch.arange(
            k + 1, dtype=torch.int32, device=dev)[None]
        logits, t_cache = t_forward(t_params, t_cfg, x, t_cache, pos,
                                    prefix_bound=t_eff, cached_prefix=True)
        g = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]

        # accept the longest matching prefix, then correct or add the bonus
        match = (g[:, :-1] == d).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1).long()  # [B] in 0..k
        return _accept(x, d, torch.take_along_dim(g, m[:, None], dim=1), m,
                       t_cache, d_cache, k)

    return spec_round


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
    the target alone under the same temperature, top_k and top_p. Returns
    (tokens int32 [B, n_tokens] on the prompt's device, the mean tokens
    emitted a round a slot, in [1, k+1]: the amortisation of a target
    forward actually reached)."""
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

    t_prefill, _ = make_decode_fns(t_forward, t_cfg)
    d_prefill, _ = make_decode_fns(d_forward, d_cfg)
    dev = prompt.device
    if sampled:
        round_s = make_spec_round_sampled(t_forward, t_cfg, d_forward, d_cfg,
                                          k)
        tv = torch.full((B,), temperature, dtype=torch.float32, device=dev)
        kv_ = torch.full((B,), top_k, dtype=torch.int32, device=dev)
        pv = torch.full((B,), top_p, dtype=torch.float32, device=dev)

        def spec_round(tp, dp, tc, dc, seed, t_eff=None, d_eff=None):
            return round_s(tp, dp, tc, dc, seed, rng, tv, kv_, pv,
                           t_eff=t_eff, d_eff=d_eff)
    else:
        spec_round = make_spec_round(t_forward, t_cfg, d_forward, d_cfg, k)

    with torch.no_grad():
        logits, t_cache = t_prefill(
            t_params, prompt, t_cache,
            t_eff=length_bucket(S, t_cache.max_len))
        a0 = sample_token(logits, rng, temperature, top_k, top_p) \
            if sampled else \
            torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        if S > 1:  # the draft holds history[0:S-1]; prompt[-1] rides the seed
            _, d_cache = d_prefill(
                d_params, prompt[:, :-1], d_cache,
                t_eff=length_bucket(S - 1, d_cache.max_len))
    seed = torch.cat([prompt[:, -1:].to(torch.int32), a0], dim=1)

    a0_host = a0.cpu().numpy()
    out = [[int(a0_host[b, 0])] for b in range(B)]
    h_max = S  # an upper bound on any slot's history length
    rounds = emitted_total = 0
    while min(len(o) for o in out) < n_tokens:
        t_eff = length_bucket(h_max + k + 2, t_cache.max_len)
        d_eff = length_bucket(h_max + k + 2, d_cache.max_len)
        emitted, n_emit, t_cache, d_cache, seed = spec_round(
            t_params, d_params, t_cache, d_cache, seed,
            t_eff=t_eff, d_eff=d_eff)
        em, ne = emitted.cpu().numpy(), n_emit.cpu().numpy()
        for b in range(B):
            out[b].extend(int(t) for t in em[b, :ne[b]])
        h_max += int(ne.max())
        rounds += 1
        emitted_total += int(ne.sum())
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
    ninf = torch.tensor(float("-inf"), dtype=l.dtype, device=l.device)
    sl = torch.where(sl < kth, ninf, sl)
    # nucleus: the smallest prefix of the sorted probabilities reaching top_p
    ps = torch.softmax(sl, dim=-1)
    keep_sorted = (torch.cumsum(ps, dim=-1) - ps) < top_p[:, None]
    inv = torch.argsort(order, dim=-1)
    keep = torch.take_along_dim(keep_sorted, inv, dim=-1)
    l = torch.where(keep & (l >= kth), l, ninf)
    p = torch.softmax(l, dim=-1)
    g = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1), V).to(p.dtype)
    return torch.where(greedy[:, None], g, p)


def _draw(probs, rng):
    """One categorical draw a row of a [B, V] weight batch: int32 [B]."""
    return torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)


def make_spec_round_sampled(t_forward, t_cfg, d_forward, d_cfg, k: int):
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
    docstring gives."""
    _check_vocab(t_cfg, d_cfg)

    @torch.no_grad()
    def spec_round(t_params, d_params, t_cache, d_cache, seed, rng,
                   temp, top_k, top_p, t_eff=None, d_eff=None):
        B = seed.shape[0]
        dev = seed.device
        # draft chain: sample each proposal, keep its q_i
        pos = d_cache.length[:, None] + torch.arange(
            2, dtype=torch.int32, device=dev)[None]
        lg, d_cache = d_forward(d_params, d_cfg, seed, d_cache, pos,
                                prefix_bound=d_eff, cached_prefix=True)
        qs, drafts = [], []
        tok = None
        for i in range(k):
            if i > 0:
                lg, d_cache = d_forward(d_params, d_cfg, tok, d_cache,
                                        d_cache.length[:, None],
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
        logits, t_cache = t_forward(t_params, t_cfg, x, t_cache, pos,
                                    prefix_bound=t_eff, cached_prefix=True)
        V = logits.shape[-1]
        p_all = _mod_probs(
            logits.to(torch.float32).reshape(B * (k + 1), V),
            temp.repeat_interleave(k + 1), top_k.repeat_interleave(k + 1),
            top_p.repeat_interleave(k + 1)).reshape(B, k + 1, V)

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

    return spec_round
