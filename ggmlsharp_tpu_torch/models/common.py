"""Shared model blocks: linear, head reshapes and cached attention (port of
ggmlsharp_tpu/models/common.py, the head-major cache with a host-side
``prefix_bound``).

``plain=True`` runs the plain PyTorch versions of the kernels on any
device (``ops.mul_mat_q`` or the integer-dot route's ``_int_dot_ref``, and
``kernels.flash._cached_ref``): the end-to-end reference a card run is held
against. By default a quantized matmul and prefill attention go through
the kernel wrappers. Both routes are differentiable with float weights: the
flash kernel's Function recomputes its backward through ``_cached_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..config import quantize_activations
from ..device import resolve_device
from ..ops.attention import NEG_INF
from ..quant.formats import QTensor, from_wire
from . import kv_cache as kvc


def _from_numpy(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(tree, device=None):
    """Carry a JAX parameter tree (any model's) across, values bit for bit.
    Dense leaves are numpy arrays (bf16 included); a quantized leaf is a
    tuple ``(gtype, ggml wire bytes, shape)`` of any block format, as the
    JAX package's ``io.gguf.qtensor_to_wire`` gives its bytes. The JAX
    package's fused
    routes keep TPU plane copies in a block (``mlp_fused``, ``layer_fused``),
    which have no meaning here: such a tree is refused. Carry the raw weights
    across and switch the routes on in the port's own ``quantize_params``
    (``mlp_fused=``, ``layer_fused=``), which makes the same matrices."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            tpu = sorted(k for k in ("mlp_fused", "layer_fused")
                         if isinstance(x.get(k), dict))
            if tpu:
                raise ValueError(
                    f"params_from_jax: {tpu} hold TPU plane copies; carry "
                    "the raw weights and pass mlp_fused= / layer_fused= to "
                    "the port's quantize_params")
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if isinstance(x, tuple):
            gtype, wire, shape = x
            return from_wire(gtype, wire, shape, device=dev)
        return _from_numpy(x).to(dev)

    return conv(tree)


def linear(w, x, b=None, quantize_acts: bool | None = None,
           plain: bool = False):
    """y = x·wᵀ (+ b). w: [n_out, k] tensor or QTensor; x: [..., k].
    quantize_acts defaults to GGML_TPU_QUANT_ACTS (on): the ggml Q8 round
    trip of the activations before a quantized matmul."""
    if isinstance(w, QTensor):
        if quantize_acts is None:
            quantize_acts = quantize_activations()
        y = ops.mul_mat(w, x, quantize_acts=quantize_acts, plain=plain)
    else:
        y = ops.mul_mat_f(w, x)
    return y if b is None else y + b


def split_heads(x, n_head):
    """[B, S, H*D] -> [B, H, S, D]"""
    B, S, HD = x.shape
    return x.reshape(B, S, n_head, HD // n_head).transpose(1, 2)


def merge_heads(x):
    """[B, H, S, D] -> [B, S, H*D]"""
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _chunk_buckets(T: int, base: int = 256):
    """Live-prefix buckets: geometric from ``base`` up to T."""
    out = []
    t = base
    while t < T:
        out.append(t)
        t *= 2
    out.append(T)
    return out


def _einsum_attention(q, k_sl, v_sl, positions, n_rep, softcap=0.0):
    """Materialised-scores attention over a [B, Hkv, t, D] prefix. GQA
    groups the q heads as [B, Hkv, n_rep, S, D]: no repeated K/V copy.
    softcap > 0: scores become tanh(s / softcap) * softcap."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    B, Hq, S, D = q.shape
    t = k_sl.shape[2]
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)
    qg = q.reshape(B, Hq // n_rep, n_rep, S, D)
    scores = torch.einsum("bgrsd,bgtd->bgrst", qg.to(torch.float32),
                          k_sl.to(torch.float32)) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = kpos[None, None, None, None, :] <= \
        positions.to(torch.int32)[:, None, None, :, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v_sl.dtype)
    out = torch.einsum("bgrst,bgtd->bgrsd", p.to(torch.float32),
                       v_sl.to(torch.float32))
    return out.reshape(B, Hq, S, D)


def flash(q, k, v, npast, plain: bool = False, softcap: float = 0.0):
    """Causal flash attention of q [B, Hq, S, D] over k/v [B, Hkv, T, D]
    with per-row npast: the kernel's autograd Function, or its plain
    version (differentiable by autograd itself)."""
    from ..kernels.flash import _cached_ref, flash_attention_cached

    if plain:
        return _cached_ref(q, k, v, npast, 1.0 / q.shape[-1] ** 0.5, softcap)
    return flash_attention_cached(q, k, v, npast, softcap=softcap)


def cached_attention(q, k_new, v_new, cache, layer, positions,
                     n_rep: int = 1, attn_softcap: float | None = None,
                     prefix_bound: int | None = None, plain: bool = False):
    """Causal attention of q over the live cache prefix of one layer.

    q, k_new, v_new: [B, H(q|kv), S, D]; positions int [B, S], contiguous
    per batch row. Writes k/v into the cache (in place), then attends over
    the first ``prefix_bound`` rows (a bound >= every position + 1; without
    one, the smallest bucket of ``_chunk_buckets`` that holds the live
    prefix). S > 8 runs the flash kernel, S <= 8 grouped einsum;
    attn_softcap caps the scores of both. Differentiable in q, k_new and
    v_new on a float cache (the rows reach the attention through the
    in-place write). Returns ([B, Hq, S, D] in q's dtype, cache)."""
    cache = kvc.update_layer(cache, layer, k_new, v_new, positions)
    softcap = attn_softcap or 0.0
    S = q.shape[2]
    T = cache.max_len
    if prefix_bound is not None:
        t = min(int(prefix_bound), T)
    else:
        lim = int(positions[:, -1].max()) + 1
        t = next(b for b in _chunk_buckets(T) if lim <= b)
    if S > 8:
        npast = positions[:, 0]
        if plain or cache.int8:
            k_sl, v_sl = kvc.read_layer(cache, layer, q.dtype, t)
            out = flash(q, k_sl, v_sl, npast, plain, softcap)
        else:
            # the stored rows (bf16) go in as a prefix view; kernel and
            # plain version widen them to f32: read_layer's values for the
            # f32 queries of the llama path
            out = flash(q, cache.k[layer][:, :, :t], cache.v[layer][:, :, :t],
                        npast, plain, softcap)
    else:
        k_sl, v_sl = kvc.read_layer(cache, layer, q.dtype, t)
        out = _einsum_attention(q, k_sl, v_sl, positions, n_rep, softcap)
    return out.to(q.dtype), cache


def lm_loss(forward, cfg, params, toks, plain: bool = False):
    """The training loss of the JAX package's bench (``BENCH_MODE=train``):
    mean next-token NLL of toks [B, S + 1] over f32 log-softmax, the forward
    run over a fresh head-major cache of S rows in the parameters' dtype
    (``wpe`` or ``norm``), positions 0..S-1 and ``prefix_bound=S``.
    forward: gpt2.forward or llama.forward with float parameters.
    Differentiable in every parameter."""
    inp, tgt = toks[:, :-1], toks[:, 1:]
    B, S = inp.shape
    dtype = (params["wpe"] if "wpe" in params else params["norm"]).dtype
    cache = kvc.init_cache(cfg.n_layer, B,
                           getattr(cfg, "n_head_kv", cfg.n_head), S,
                           cfg.head_dim, dtype=dtype, device=toks.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=toks.device)[None].expand(B, S)
    logits, _ = forward(params, cfg, inp, cache, positions, prefix_bound=S,
                        plain=plain)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, tgt.long()[..., None]).mean()
