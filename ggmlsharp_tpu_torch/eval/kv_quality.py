"""KV-cache quality on the decode path (port of scripts/kv_quality.py:40-130,
the functions; the command line is scripts/kv_quality_torch.py).

Teacher-forced decode scoring: held-out ids are cut into chunks, and every
chunk decodes token by token through a real KV cache (positions advancing,
the chunks batched as slots); each step's logits score the next token.
Prefill perplexity never reads a quantized cache row, so it cannot see the
cache's rounding; this does. The caches compared, each a flat or head-major
``kv_cache.init_cache``:

  f32 head-major (the exact reference) | bf16 flat | int8 flat

The flat ones are forced flat (the JAX script does the same), so on the
card every step's attention is the attn_decode kernel. Reports decode ppl,
dppl and the per-step argmax agreement against f32. The JAX script jits the
step; here each cache's step is one ``models.captured.CapturedStep`` (on
the card one CUDA graph, replayed T - 1 times): the token column and the
positions are copied into its static buffers, it writes the cache (rows
and length) in place, and its logits are cloned before the host scores
them, as the JAX script scores its step's output. Inside
``captured.disabled()`` the same step runs eagerly (the eager form).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import kv_cache as kvc
from ..models import llama
from ..models.captured import CapturedStep

S = 128  # chunk length: S - 1 decode steps a chunk
CACHES = [("f32 head-major (ref)", torch.float32, False, False),
          ("bf16 flat (attn_decode)", torch.bfloat16, False, True),
          ("int8 flat (attn_decode)", torch.bfloat16, True, True)]


def chunks(heldout, n_chunks: int, chunk: int = S):
    """(X, Y) int32 [B, chunk]: B = min(n_chunks, (len - 1) // chunk)
    consecutive windows of ``heldout`` and their next tokens."""
    B = min(n_chunks, (len(heldout) - 1) // chunk)
    X = np.asarray(heldout[:B * chunk], np.int32).reshape(B, chunk)
    Y = np.asarray(heldout[1:B * chunk + 1], np.int32).reshape(B, chunk)
    return X, Y


@torch.inference_mode()
def decode_score(cfg, params, X, Y, dtype, int8: bool, flat: bool):
    """Teacher-forced decode of X [B, T] through a fresh cache of T rows on
    the parameters' device, T - 1 single-token steps. Returns (ppl, argmax
    [T - 1, B], scored tokens)."""
    from .perplexity import _device_of

    dev = _device_of(params)
    B, T = X.shape
    cache = kvc.init_cache(cfg.n_layer, B, cfg.n_head_kv, T, cfg.head_dim,
                           dtype=dtype, int8=int8, flat=flat, device=dev)
    toks = torch.as_tensor(X, device=dev)

    def body(tok, pos):
        logits, out = llama.forward(params, cfg, tok, cache, pos)
        cache.length.copy_(out.length)
        return logits[:, -1]

    step = CapturedStep(body, state=(cache.length,))
    nll_sum, n, tops = 0.0, 0, []
    for t in range(T - 1):
        pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
        # a clone: the graph's logits buffer is rewritten by its next replay
        logits = step(toks[:, t:t + 1], pos).clone()
        lg = logits.to(torch.float32).cpu().numpy()
        lg = lg - lg.max(-1, keepdims=True)
        lse = np.log(np.exp(lg).sum(-1))
        nll_sum += float((lse - lg[np.arange(B), Y[:, t]]).sum())
        n += B
        tops.append(lg.argmax(-1))
    return float(np.exp(nll_sum / n)), np.stack(tops), n


def run(cfg, params, X, Y, caches=CACHES, log=None):
    """Every cache of ``caches`` (the first is the reference): rows
    (name, ppl, dppl vs the reference, argmax agreement with it)."""
    rows, ref = [], None
    for name, dtype, int8, flat in caches:
        ppl, top, n = decode_score(cfg, params, X, Y, dtype, int8, flat)
        if ref is None:
            ref = (ppl, top)
        rows.append((name, ppl, ppl - ref[0], float((top == ref[1]).mean())))
        if log:
            log(f"[{name}] decode-path ppl={ppl:.4f} ({n} scored) "
                f"dppl={rows[-1][2]:+.4f} argmax-agree={rows[-1][3]:.4f}")
    return rows


def append_doc(path: str, rows, card: str, B: int, head_dim: int,
               wall_s: float, command: str):
    """Append the table to ``path`` (docs/PPL_CHAIN_TORCH.md)."""
    with open(path, "a") as fh:
        fh.write(
            "\n## KV-cache quality on the DECODE path "
            "(scripts/kv_quality_torch.py)\n\n"
            f"Teacher-forced decode scoring of the held-out ids through a "
            f"real KV cache ({B} chunks batched as slots, {S - 1} "
            "single-token steps each: the path the serving engine runs; the "
            "prefill table above never reads a quantized cache row). fp32 "
            "weights (the seed-0 chain model's GGUF); the cache is the only "
            "variable, the flat ones through the attn_decode kernel on the "
            f"card (head_dim {head_dim}). Card: {card}. Wall time "
            f"{wall_s:.0f} s. "
            f"Regenerate: `{command}`.\n\n"
            "| Cache | decode ppl | dppl vs f32 | argmax agree |\n"
            "|---|---|---|---|\n")
        for name, p, d, ag in rows:
            fh.write(f"| {name} | {p:.4f} | {d:+.4f} | {ag:.4f} |\n")
        fh.write(
            "\nThe int8 row is the serving engine's INT8 cache "
            "(`Engine(int8_kv=True)`, `GGML_TPU_INT8_KV`).\n")
