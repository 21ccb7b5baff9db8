"""Perplexity and quantization quality (port of
ggmlsharp_tpu/eval/perplexity.py).

``perplexity(forward, cfg, params, tokens)`` is llama.cpp's sliding
evaluation: cut the token stream into chunk_len windows, score the
next-token NLL over the second half of each window, report exp(mean NLL).
A window is one forward of chunk_len - 1 rows over a fresh head-major f32
cache: on the card, the multi-row dequant-matmuls and flash prefill.

``quantization_quality`` measures the degradation of a quantized copy
without external data: Δppl and the mean logits KL between the two on text
sampled from the float model itself. The absolute perplexity of random
weights means nothing; the delta under quantization is the quantity.

The JAX package jits the chunk; the port runs it eagerly. A
``torch.Generator`` takes the place of the JAX key, so a sampled stream
differs from the JAX package's; ``logits_kl`` and ``perplexity`` on a given
stream compute the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import kv_cache as kvc
from ..models import sampling
from ..quant.formats import QTensor


def _device_of(params) -> torch.device:
    """The device of the first tensor in a parameter tree."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return node.device
        if isinstance(node, QTensor):
            return next(iter(node.planes.values())).device
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(list(node)))
    raise ValueError("the parameter tree holds no tensor")


def _chunk_logits(forward, cfg, params, inp):
    """Log-softmax of the logits of inp [B, S] over a fresh head-major f32
    cache of S rows, positions 0..S-1."""
    B, S = inp.shape
    cache = kvc.init_cache(cfg.n_layer, B,
                           getattr(cfg, "n_head_kv", cfg.n_head), S,
                           cfg.head_dim, dtype=torch.float32,
                           device=inp.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=inp.device)[None].expand(B, S)
    logits, _ = forward(params, cfg, inp, cache, positions)
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


@torch.inference_mode()
def nll_chunk(forward, cfg, params, chunk):
    """chunk: int [B, S] -> per-token NLL [B, S - 1] (f32): one forward of
    chunk[:, :-1], scored against chunk[:, 1:]."""
    logp = _chunk_logits(forward, cfg, params, chunk[:, :-1])
    return -torch.gather(logp, -1, chunk[:, 1:].long()[..., None])[..., 0]


def perplexity(forward, cfg, params, tokens, chunk_len: int = 256,
               stride: int | None = None, score_tail_only: bool = True):
    """tokens: int [N] stream -> (ppl, mean_nll, n_scored), computed on the
    parameters' device."""
    dev = _device_of(params)
    tokens = np.asarray(tokens, np.int32)
    stride = stride or chunk_len
    lo = chunk_len // 2 if score_tail_only else 0
    total, count = 0.0, 0
    for start in range(0, len(tokens) - chunk_len, stride):
        chunk = torch.from_numpy(tokens[start:start + chunk_len][None]).to(dev)
        nll = nll_chunk(forward, cfg, params, chunk)[0, lo:]
        total += float(nll.sum())
        count += nll.numel()
    mean_nll = total / max(count, 1)
    return float(np.exp(mean_nll)), mean_nll, count


@torch.inference_mode()
def logits_kl(forward, cfg, params_fp, params_q, stream,
              chunk_len: int = 128) -> float:
    """Mean KL(fp || q) of the next-token distributions over the first
    chunk_len tokens of ``stream``."""
    dev = _device_of(params_fp)
    chunk = torch.as_tensor(np.asarray(stream[:chunk_len], np.int32)[None],
                            device=dev)
    lp_fp = _chunk_logits(forward, cfg, params_fp, chunk)
    lp_q = _chunk_logits(forward, cfg, params_q, chunk)
    return float(torch.mean(torch.sum(torch.exp(lp_fp) * (lp_fp - lp_q),
                                      dim=-1)))


def quantization_quality(forward, cfg, params_fp, params_q, rng=None,
                         n_tokens: int = 512, chunk_len: int = 128,
                         stream=None):
    """Δppl and logits KL between float and quantized parameters on text
    sampled from the float model (temperature 1, top-k 40, from an 8-token
    random prompt; ``rng``: a torch.Generator on the parameters' device,
    default seeded with 0). ``stream``: score this token stream instead of
    sampling one."""
    if stream is None:
        dev = _device_of(params_fp)
        rng = rng if rng is not None else torch.Generator(dev).manual_seed(0)
        prompt = torch.randint(0, cfg.n_vocab, (1, 8), generator=rng,
                               device=dev, dtype=torch.int32)
        cache = kvc.init_cache(cfg.n_layer, 1,
                               getattr(cfg, "n_head_kv", cfg.n_head),
                               n_tokens + 16, cfg.head_dim,
                               dtype=torch.float32, device=dev)
        toks, _ = sampling.generate(forward, cfg, params_fp, prompt, cache,
                                    n_tokens, temperature=1.0, top_k=40,
                                    rng=rng)
        stream = torch.cat([prompt[0], toks[0]]).cpu().numpy()
    ppl_fp, _, _ = perplexity(forward, cfg, params_fp, stream, chunk_len)
    ppl_q, _, _ = perplexity(forward, cfg, params_q, stream, chunk_len)
    return {
        "ppl_fp": ppl_fp,
        "ppl_q": ppl_q,
        "delta_ppl": ppl_q - ppl_fp,
        "mean_kl": logits_kl(forward, cfg, params_fp, params_q, stream,
                             chunk_len),
    }


def compare_quantizers(forward, cfg, params_fp, quantize_fns: dict,
                       rng=None, n_tokens: int = 256, chunk_len: int = 128):
    """A quality ladder of alternative quantizers of one format:
    {name: quantization_quality of quantize_fns[name](params_fp)}. Each
    entry draws its stream from the same seed."""
    dev = _device_of(params_fp)
    seed = int(rng.initial_seed()) if rng is not None else 0
    return {name: quantization_quality(
                forward, cfg, params_fp, qfn(params_fp),
                rng=torch.Generator(dev).manual_seed(seed),
                n_tokens=n_tokens, chunk_len=chunk_len)
            for name, qfn in quantize_fns.items()}
