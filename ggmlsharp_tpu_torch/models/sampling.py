"""Decode loops: prefill, then greedy single-token steps over a KV cache
(port of ggmlsharp_tpu/models/sampling.py:16-57, 117-149).

Works with any model module exposing
forward(params, cfg, tokens, cache, positions, prefix_bound=...). PyTorch
runs eagerly, so the JAX package's jitted prefill/step become plain
functions; the live-prefix bound is tracked on the host as there.
Sampling with a temperature, top-k/top-p and the repetition penalty are not
ported yet and raise.
"""
from __future__ import annotations

import torch

from .common import _chunk_buckets


def length_bucket(n: int, max_len: int, base: int = 256) -> int:
    """Smallest geometric bucket >= n (common._chunk_buckets): attention
    reads only that many cache rows."""
    for b in _chunk_buckets(max_len, base=base):
        if n <= b:
            return b
    return max_len


def make_decode_fns(forward, cfg):
    """Returns (prefill, step).

    prefill(params, tokens [B, S], cache, t_eff=None) -> (last logits [B, V], cache)
    step(params, token [B, 1], cache, t_eff=None) -> (logits [B, V], cache)
    """

    def prefill(params, tokens, cache, t_eff=None):
        S = tokens.shape[1]
        positions = cache.length[:, None] + torch.arange(
            S, dtype=torch.int32, device=tokens.device)[None, :]
        logits, cache = forward(params, cfg, tokens, cache, positions,
                                prefix_bound=t_eff)
        return logits[:, -1, :], cache

    def step(params, token, cache, t_eff=None):
        positions = cache.length[:, None]
        logits, cache = forward(params, cfg, token, cache, positions,
                                prefix_bound=t_eff)
        return logits[:, -1, :], cache

    return prefill, step


@torch.inference_mode()
def generate(forward, cfg, params, prompt, cache, n_tokens: int,
             temperature: float = 0.0, top_k: int = 0, rng=None,
             echo_logits: bool = False, top_p: float = 1.0,
             repeat_penalty: float = 1.0, repeat_last_n: int = 64):
    """Host-driven greedy decode: prefill once, then n_tokens single-token
    steps. prompt: int [B, S] on the cache's device. Returns
    (tokens int32 [B, n_tokens], cache)."""
    if temperature > 0.0 or top_k or top_p < 1.0 or repeat_penalty != 1.0 \
            or rng is not None:
        raise NotImplementedError("only greedy sampling is ported yet")
    prefill, step = make_decode_fns(forward, cfg)
    T = cache.max_len
    # host-tracked upper bound on the live prefix (one small fetch up front)
    cur = prompt.shape[1] + int(cache.length.max())
    logits, cache = prefill(params, prompt, cache, t_eff=length_bucket(cur, T))
    out = []
    for _ in range(n_tokens):
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        out.append(tok)
        cur += 1
        logits, cache = step(params, tok, cache, t_eff=length_bucket(cur, T))
    return torch.cat(out, dim=1), cache
