"""GPT-J family (port of ggmlsharp_tpu/models/gptj.py): a parallel-residual
decoder with partial rotary embeddings.

ONE pre-LayerNorm a block feeds attention AND the MLP (x + attn(h) + mlp(h),
one residual join a block); rotary embeddings cover only the first
``rotary_dim`` dims of each head (interleaved pairs, ``ops.rope`` mode 0);
the attention projections carry no bias, the MLP and the LM head do.
Weights are tensors or QTensors. The cache is head-major only, so every
route is the per-op loop over ``common.cached_attention`` (flash for the
prompt, grouped einsum for decode); the Q4_0 matmuls run the dequant-matmul
kernel at one row and its multi-row instance above.

dtype flow, as in the JAX package: the stream takes ``ln_f``'s dtype (bf16
from ``init_params``), each block's two branch outputs are cast to it before
the join; logits are f32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..dtypes import GType
from ..ops import gelu, get_rows, rope
from ..quant.formats import QTensor
from ..quant.quantize import quantize
from . import kv_cache as kvc
from .common import cached_attention, linear, merge_heads, split_heads
from .common import params_from_jax  # noqa: F401  (gptj.params_from_jax)
from .gpt2 import _layer_norm


@dataclass(frozen=True)
class GPTJConfig:
    n_vocab: int = 50400
    n_ctx: int = 2048
    n_embd: int = 4096
    n_head: int = 16
    n_layer: int = 28
    rotary_dim: int = 64  # rotary over the first dims of each head only
    ln_eps: float = 1e-5

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @property
    def n_head_kv(self):  # no GQA in the family; cache helpers read it
        return self.n_head

    @property
    def n_ff(self):
        return 4 * self.n_embd


GPTJ_6B = GPTJConfig()
TINY_GPTJ = GPTJConfig(n_vocab=128, n_ctx=64, n_embd=64, n_head=4,
                       n_layer=2, rotary_dim=8)


def init_params(cfg: GPTJConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.bfloat16):
    """Random weights N(0, 0.02), unit layer-norm gains, zero biases.
    ``generator`` must live on ``device``; None means a fresh one seeded
    with 0."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(0)
    E, F = cfg.n_embd, cfg.n_ff

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def ln():
        return {"g": torch.ones(E, dtype=dtype, device=dev),
                "b": torch.zeros(E, dtype=dtype, device=dev)}

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    return {
        "wte": w(cfg.n_vocab, E),
        "ln_f": ln(),
        "lm_head": {"w": w(cfg.n_vocab, E), "b": zeros(cfg.n_vocab)},
        "blocks": [
            {"ln_1": ln(),
             "attn": {"wq": w(E, E), "wk": w(E, E), "wv": w(E, E),
                      "wo": w(E, E)},
             "mlp": {"fc_in_w": w(F, E), "fc_in_b": zeros(F),
                     "fc_out_w": w(E, F), "fc_out_b": zeros(E)}}
            for _ in range(cfg.n_layer)
        ],
    }


def quantize_params(params, gtype: GType, min_cols: int = 256,
                    search: bool = False):
    """Weight-only quantization of every matmul weight, the embedding and
    the LM head included: 2-D leaves whose rows are whole 256-element
    groups and at least ``min_cols`` wide. Biases and layer norms stay float
    (llama.cpp's policy). ``wte`` keeps its rows for ``get_rows``."""

    def q(t):
        if isinstance(t, QTensor) or t.dim() != 2 or t.shape[-1] % 256 \
                or t.shape[-1] < min_cols:
            return t
        return quantize(t.to(torch.float32), gtype, search=search)

    return {
        "wte": q(params["wte"]),
        "ln_f": params["ln_f"],
        "lm_head": {"w": q(params["lm_head"]["w"]),
                    "b": params["lm_head"]["b"]},
        "blocks": [
            {"ln_1": b["ln_1"],
             "attn": {k: q(v) for k, v in b["attn"].items()},
             "mlp": {"fc_in_w": q(b["mlp"]["fc_in_w"]),
                     "fc_in_b": b["mlp"]["fc_in_b"],
                     "fc_out_w": q(b["mlp"]["fc_out_w"]),
                     "fc_out_b": b["mlp"]["fc_out_b"]}}
            for b in params["blocks"]
        ],
    }


def synthetic_params(cfg: GPTJConfig, gtype: GType, seed: int = 0,
                     device=None):
    """A parameter tree in ``gtype`` (every matmul weight and both tables,
    as quantize_params gives it) from random weights drawn on ``device`` from
    ``seed``: each matrix is drawn in f32, quantized by the port's quantizer
    and freed before the next, so no f32 copy of the model exists (at 6B it
    would take 24 GB; the largest matrix, fc_in, is 268 MB). Weights are
    N(0, 1/k) for k inputs (a unit-RMS row gives unit-RMS outputs),
    embedding rows N(0, 1); wo and fc_out are scaled by 1/sqrt(2·n_layer),
    GPT-2's residual init, as ``llama.synthetic_params`` does; unit
    layer-norm gains; biases 0.02·N(0, 1), bf16 as ``init_params`` keeps
    them."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    E, F = cfg.n_embd, cfg.n_ff
    res = (2 * cfg.n_layer) ** -0.5
    bf16 = torch.bfloat16

    def qt(n, k, scale=1.0):
        w = torch.randn((n, k), generator=gen, device=dev)
        return quantize(w.mul_(scale / k ** 0.5), gtype)

    def vec(n):
        return (torch.randn(n, generator=gen, device=dev) * 0.02).to(bf16)

    def ln():
        return {"g": torch.ones(E, dtype=bf16, device=dev),
                "b": torch.zeros(E, dtype=bf16, device=dev)}

    return {
        "wte": qt(cfg.n_vocab, E, E ** 0.5),
        "ln_f": ln(),
        "lm_head": {"w": qt(cfg.n_vocab, E), "b": vec(cfg.n_vocab)},
        "blocks": [
            {"ln_1": ln(),
             "attn": {"wq": qt(E, E), "wk": qt(E, E), "wv": qt(E, E),
                      "wo": qt(E, E, res)},
             "mlp": {"fc_in_w": qt(F, E), "fc_in_b": vec(F),
                     "fc_out_w": qt(E, F, res), "fc_out_b": vec(E)}}
            for _ in range(cfg.n_layer)
        ],
    }


def forward(params, cfg: GPTJConfig, tokens, cache: kvc.KVCache, positions,
            prefix_bound: int | None = None,
            cached_prefix: bool | None = None, plain: bool = False):
    """tokens/positions: int [B, S]. Returns (logits f32 [B, S, n_vocab],
    cache advanced by S); the cache (head-major only) is written in place.
    cached_prefix is taken for the engine's signature: the head-major cache
    always attends its live prefix. plain: run the kernels' plain PyTorch
    versions (a card run's reference)."""
    del cached_prefix
    x = get_rows(params["wte"], tokens).to(params["ln_f"]["g"].dtype)
    H = cfg.n_head
    for i, blk in enumerate(params["blocks"]):
        attn, mlp = blk["attn"], blk["mlp"]
        h = _layer_norm(x, blk["ln_1"], cfg.ln_eps)
        q = rope(split_heads(linear(attn["wq"], h, plain=plain), H),
                 positions, n_dims=cfg.rotary_dim, mode=0)
        k = rope(split_heads(linear(attn["wk"], h, plain=plain), H),
                 positions, n_dims=cfg.rotary_dim, mode=0)
        v = split_heads(linear(attn["wv"], h, plain=plain), H)
        a, cache = cached_attention(q, k, v, cache, i, positions,
                                    prefix_bound=prefix_bound, plain=plain)
        attn_out = linear(attn["wo"], merge_heads(a), plain=plain)
        mlp_out = linear(mlp["fc_out_w"],
                         gelu(linear(mlp["fc_in_w"], h, mlp["fc_in_b"],
                                     plain=plain)),
                         mlp["fc_out_b"], plain=plain)
        # parallel residual: one join a block
        x = x + attn_out.to(x.dtype) + mlp_out.to(x.dtype)
    x = _layer_norm(x, params["ln_f"], cfg.ln_eps)
    logits = linear(params["lm_head"]["w"], x, params["lm_head"]["b"],
                    plain=plain)
    return logits.to(torch.float32), kvc.advance(cache, tokens.shape[1])


def new_cache(cfg: GPTJConfig, batch: int, dtype=torch.bfloat16,
              int8: bool = False, max_len: int | None = None,
              flat: bool | None = None, device=None) -> kvc.KVCache:
    """A head-major [B, H, T, D] cache of T = max_len or n_ctx rows (``flat``
    is taken for the other models' signature and ignored, as in the JAX
    package)."""
    del flat
    return kvc.init_cache(cfg.n_layer, batch, cfg.n_head,
                          max_len or cfg.n_ctx, cfg.head_dim, dtype=dtype,
                          int8=int8, device=resolve_device(device))
