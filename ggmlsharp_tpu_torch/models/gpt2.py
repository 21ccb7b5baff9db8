"""GPT-2 (port of ggmlsharp_tpu/models/gpt2.py): learned position
embeddings, pre-LN blocks, fused-QKV attention with biases, GELU MLP, LM head
tied to the token embedding.

Parameters are plain dicts that mirror the JAX tree (``wte``, ``wpe``,
``ln_f``, ``blocks`` of ``ln_1``/``attn``/``ln_2``/``mlp``). A weight is a
tensor or a QTensor; a block keeps ONE copy of each weight, ggml's own block
bytes, and every kernel reads that copy. ``wte`` serves both ``get_rows`` and
the LM head (the Q8_0 kernel masks the ragged row edge, so nothing is padded).

``forward`` has the JAX package's three routes, chosen by the same rules:
  1. batch 1, one token, flat float cache, GGML_TPU_LAYER_FUSED on (the
     default; JAX reads it when it quantizes), every block Q8_0 and within
     ``gpt2_layer_fuse_supported``: one ``gpt2_layer_step`` a block (the
     whole-block kernel), the caller writing the block's K/V row; f32
     stream, no Q8_0 activation round trip;
  2. flat cache otherwise (prefill): per-matmul ``linear`` with bias, rows
     written to the flat cache, flash over the call's fresh K/V when S > 8
     and not ``cached_prefix``, else exact attention over the rows read
     back; the MLP through ``flash_ff_q8`` up to 64 rows;
  3. head-major cache (batch > 1 or INT8): ``common.cached_attention``, the
     same MLP rule.
The residual stream starts in ``wpe``'s dtype on routes 2-3 and in f32 on
route 1; layer norm normalises in f32 and casts back.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import layer_fused, quantize_activations
from ..device import resolve_device
from ..dtypes import GType
from ..kernels.config import mm_dot_mode
from ..kernels.gpt2_layer import _layer_ref, block_fusable, gpt2_layer_step
from ..kernels.mlp_fused import _ff_ref, flash_ff_q8, mlp_fuse_supported
from ..ops import gelu, get_rows, mul_mat_f, norm
from ..quant.formats import QTensor
from ..quant.quantize import quantize
from . import kv_cache as kvc
from .common import (_einsum_attention, cached_attention, flash, linear,
                     merge_heads, split_heads)
from .common import params_from_jax  # noqa: F401  (gpt2.params_from_jax)


@dataclass(frozen=True)
class GPT2Config:
    n_vocab: int = 50257
    n_ctx: int = 1024
    n_embd: int = 768
    n_head: int = 12
    n_layer: int = 12
    ln_eps: float = 1e-5

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


GPT2_124M = GPT2Config()
GPT2_355M = GPT2Config(n_embd=1024, n_head=16, n_layer=24)
GPT2_774M = GPT2Config(n_embd=1280, n_head=20, n_layer=36)
GPT2_TINY = GPT2Config(  # test-scale config
    n_vocab=256, n_ctx=128, n_embd=128, n_head=4, n_layer=2)
GPT2_1558M = GPT2Config(n_embd=1600, n_head=25, n_layer=48)


def init_params(cfg: GPT2Config, generator: torch.Generator | None = None,
                device=None, dtype=torch.bfloat16):
    """Random weights N(0, 0.02), unit gains, zero biases. ``generator`` must
    live on ``device``; None means a fresh one seeded with 0."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(0)
    E = cfg.n_embd

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def ln():
        return {"g": torch.ones(E, dtype=dtype, device=dev),
                "b": torch.zeros(E, dtype=dtype, device=dev)}

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    return {
        "wte": w(cfg.n_vocab, E),
        "wpe": w(cfg.n_ctx, E),
        "ln_f": ln(),
        "blocks": [
            {
                "ln_1": ln(),
                "attn": {"c_attn_w": w(3 * E, E), "c_attn_b": zeros(3 * E),
                         "c_proj_w": w(E, E), "c_proj_b": zeros(E)},
                "ln_2": ln(),
                "mlp": {"c_fc_w": w(4 * E, E), "c_fc_b": zeros(4 * E),
                        "c_proj_w": w(E, 4 * E), "c_proj_b": zeros(E)},
            }
            for _ in range(cfg.n_layer)
        ],
    }


def quantize_params(params, gtype: GType, min_cols: int = 256,
                    search: bool = False):
    """Weight-only quantization of every matmul weight, the embedding
    included: 2-D leaves whose rows are whole 256-element groups and at
    least ``min_cols`` wide. Biases, layer norms and ``wpe`` stay float.
    ``search`` goes to ``quantize`` (the k-quants' scale search)."""

    def q(t):
        if isinstance(t, QTensor) or t.dim() != 2 or t.shape[-1] % 256 \
                or t.shape[-1] < min_cols:
            return t
        return quantize(t.to(torch.float32), gtype, search=search)

    def q_pair(d, wa, wb):
        return {k: (q(v) if k in (wa, wb) else v) for k, v in d.items()}

    return {
        "wte": q(params["wte"]),
        "wpe": params["wpe"],
        "ln_f": params["ln_f"],
        "blocks": [
            {"ln_1": b["ln_1"],
             "attn": q_pair(b["attn"], "c_attn_w", "c_proj_w"),
             "ln_2": b["ln_2"],
             "mlp": q_pair(b["mlp"], "c_fc_w", "c_proj_w")}
            for b in params["blocks"]
        ],
    }


_Q8_RMS = 73.6  # RMS of an integer uniform on [-127, 127]


def random_q8_0(n: int, k: int, generator: torch.Generator, device,
                scale: float | None = None) -> QTensor:
    """A random Q8_0 [n, k] drawn on ``device``: int8 values uniform in
    [-127, 127] and f16 scales in [0.5, 1.5)·s with s = 1 / (73.6·sqrt(k))
    by default, so a unit-RMS input row gives unit-RMS outputs."""
    s = scale if scale is not None else 1.0 / (_Q8_RMS * k ** 0.5)
    qs = torch.randint(-127, 128, (n, k), generator=generator, device=device,
                       dtype=torch.int8)
    d = ((torch.rand((n, k // 32), generator=generator, device=device) + 0.5)
         * s).to(torch.float16)
    return QTensor(GType.Q8_0, (n, k), {"qs": qs, "d": d})


def synthetic_q8_0_params(cfg: GPT2Config, seed: int = 0, device=None):
    """A Q8_0 parameter tree of random_q8_0 weights drawn directly on
    ``device`` from ``seed``, with no f32 staging copy. Embedding rows have
    RMS 1/sqrt(E), so the tied LM head gives logits of RMS about 1; gains
    are 1 + 0.1·N(0, 1) and biases 0.02·N(0, 1), bf16 as ``init_params``
    keeps them. The projections back into the residual stream (attn c_proj,
    mlp c_proj) are scaled by 1/sqrt(2·n_layer), GPT-2's residual init, so
    the blocks' updates sum to an RMS of about 0.5 an element. ``wpe`` has
    that RMS too: random blocks pull every input toward one direction (GELU
    and the attention average have non-zero means), and with a small ``wpe``
    the greedy stream repeats one token; a position row as large as the
    summed updates keeps the final stream, and so the argmax, changing from
    step to step (28 or more distinct tokens in 32 at 124M and 774M)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    E, F = cfg.n_embd, 4 * cfg.n_embd
    res = (2 * cfg.n_layer) ** -0.5
    bf16 = torch.bfloat16

    def qt(n, k, scale=None):
        return random_q8_0(n, k, gen, dev, scale)

    def vec(n, std, mean=0.0):
        return (torch.randn(n, generator=gen, device=dev) * std
                + mean).to(bf16)

    def ln():
        return {"g": vec(E, 0.1, 1.0), "b": vec(E, 0.02)}

    return {
        "wte": qt(cfg.n_vocab, E, 1.0 / (_Q8_RMS * E ** 0.5)),
        "wpe": (torch.randn((cfg.n_ctx, E), generator=gen, device=dev)
                * 0.5).to(bf16),
        "ln_f": ln(),
        "blocks": [
            {
                "ln_1": ln(),
                "attn": {"c_attn_w": qt(3 * E, E), "c_attn_b": vec(3 * E, 0.02),
                         "c_proj_w": qt(E, E, res / (_Q8_RMS * E ** 0.5)),
                         "c_proj_b": vec(E, 0.02)},
                "ln_2": ln(),
                "mlp": {"c_fc_w": qt(F, E), "c_fc_b": vec(F, 0.02),
                        "c_proj_w": qt(E, F, res / (_Q8_RMS * F ** 0.5)),
                        "c_proj_b": vec(E, 0.02)},
            }
            for _ in range(cfg.n_layer)
        ],
    }


def _layer_norm(x, p, eps):
    return norm(x.to(torch.float32), eps=eps).to(x.dtype) * p["g"] + p["b"]


def _embed(params, cfg: GPT2Config, tokens, positions):
    pos = positions.long().clamp(0, cfg.n_ctx - 1)
    return get_rows(params["wte"], tokens) + params["wpe"][pos]


def _lm_head(params, cfg: GPT2Config, x, plain):
    wte = params["wte"]
    if isinstance(wte, QTensor):
        logits = linear(wte, x.to(torch.float32), quantize_acts=False,
                        plain=plain)
    else:
        logits = mul_mat_f(wte, x.to(wte.dtype))
    return logits[..., :cfg.n_vocab].to(torch.float32)


def _forward_layer_decode(params, cfg: GPT2Config, tokens, cache, positions,
                          prefix_bound, plain):
    """Route 1: one whole-block call a layer, the block's new K/V row written
    to the flat cache here, after the call that read the cache."""
    E = cfg.n_embd
    x = _embed(params, cfg, tokens, positions).reshape(1, E) \
        .to(torch.float32).contiguous()
    npast = positions[0].to(torch.int32)  # [1], read on the device
    widx = kvc.flat_index(cache, positions)
    T = cache.max_len if prefix_bound is None else \
        min(int(prefix_bound), cache.max_len)
    step = _layer_ref if plain else gpt2_layer_step
    for i, blk in enumerate(params["blocks"]):
        x, kn, vn = step(blk, x, cache.k[i][0, :T], cache.v[i][0, :T], npast,
                         cfg.n_head, cfg.ln_eps)
        cache = kvc.update_layer_flat(cache, i, kn, vn, positions, widx)
    x = _layer_norm(x, params["ln_f"], cfg.ln_eps)
    logits = _lm_head(params, cfg, x, plain)
    return logits.reshape(1, 1, -1), kvc.advance(cache, 1)


def _flat_attention(q, k, v, cache, i, positions, widx, cfg: GPT2Config,
                    prefix_bound, cached_prefix, plain):
    """Route 2's attention: q, k, v [B, S, E]. Writes this call's rows (at
    widx = flat_index of the positions), then
    flash over the fresh K/V (S > 8 from an empty prefix) or exact attention
    over the live rows read back from the cache. Returns [B, S, E]."""
    B, S, E = q.shape
    H = cfg.n_head
    cache = kvc.update_layer_flat(cache, i, k, v, positions, widx)
    qh = split_heads(q, H)
    if S > 8 and not cached_prefix:
        a = flash(qh, split_heads(k, H).contiguous(),
                  split_heads(v, H).contiguous(), positions[:, 0], plain)
    else:
        t = cache.max_len if prefix_bound is None else \
            min(int(prefix_bound), cache.max_len)
        kc, vc = kvc.read_layer_flat(cache, i, t)
        a = _einsum_attention(
            qh, kc.reshape(B, t, H, E // H).transpose(1, 2).to(q.dtype),
            vc.reshape(B, t, H, E // H).transpose(1, 2).to(q.dtype),
            positions, 1)
    return merge_heads(a).to(q.dtype), cache


def _mlp(blk, h, out_dtype, plain):
    """gelu(h·fcᵀ + b)·projᵀ + b: the fused kernel up to 64 rows of a Q8_0
    pair (cast to the stream's dtype), two linears otherwise."""
    m = blk["mlp"]
    rows = h.numel() // h.shape[-1]
    if mlp_fuse_supported(m["c_fc_w"], m["c_proj_w"], rows):
        ff = _ff_ref if plain else flash_ff_q8
        return ff(m["c_fc_w"], m["c_fc_b"], m["c_proj_w"], m["c_proj_b"], h,
                  quantize_acts=quantize_activations(),
                  mode=mm_dot_mode()).to(out_dtype)
    h = gelu(linear(m["c_fc_w"], h, m["c_fc_b"], plain=plain))
    return linear(m["c_proj_w"], h, m["c_proj_b"], plain=plain)


def forward(params, cfg: GPT2Config, tokens, cache: kvc.KVCache, positions,
            prefix_bound: int | None = None,
            cached_prefix: bool | None = None, plain: bool = False):
    """tokens/positions: int [B, S]. Returns (logits f32 [B, S, n_vocab],
    cache advanced by S). The cache is written in place. prefix_bound: a
    host-side bound on the live cache prefix (sampling.length_bucket).
    cached_prefix: whether a multi-token call over a flat cache attends the
    cache's live prefix (needed when positions do not start at 0) or flash
    over its own fresh K/V; None means the former for S <= 8.
    plain: run the kernels' plain PyTorch versions (a card run's reference)."""
    B, S = tokens.shape
    if (cache.is_flat and not cache.int8 and S == 1 and B == 1
            and layer_fused()
            and all(block_fusable(b) for b in params["blocks"])):
        return _forward_layer_decode(params, cfg, tokens, cache, positions,
                                     prefix_bound, plain)
    x = _embed(params, cfg, tokens, positions).to(params["wpe"].dtype)
    widx = kvc.flat_index(cache, positions) if cache.is_flat else None
    for i, blk in enumerate(params["blocks"]):
        attn = blk["attn"]
        h = _layer_norm(x, blk["ln_1"], cfg.ln_eps)
        qkv = linear(attn["c_attn_w"], h, attn["c_attn_b"], plain=plain)
        q, k, v = qkv.split(cfg.n_embd, dim=-1)
        if cache.is_flat:
            a, cache = _flat_attention(q, k, v, cache, i, positions, widx,
                                       cfg, prefix_bound, cached_prefix, plain)
        else:
            a, cache = cached_attention(
                split_heads(q, cfg.n_head), split_heads(k, cfg.n_head),
                split_heads(v, cfg.n_head), cache, i, positions,
                prefix_bound=prefix_bound, plain=plain)
            a = merge_heads(a)
        x = x + linear(attn["c_proj_w"], a, attn["c_proj_b"], plain=plain)
        h = _layer_norm(x, blk["ln_2"], cfg.ln_eps)
        x = x + _mlp(blk, h, x.dtype, plain)
    x = _layer_norm(x, params["ln_f"], cfg.ln_eps)
    return _lm_head(params, cfg, x, plain), kvc.advance(cache, S)


def new_cache(cfg: GPT2Config, batch: int, dtype=torch.bfloat16,
              int8: bool = False, max_len: int | None = None,
              flat: bool | None = None, device=None) -> kvc.KVCache:
    """A cache of T = max_len or n_ctx rows. flat=None: the flat [B, T, E]
    layout (decode through the whole-block kernel) for single-slot float
    decode while GGML_TPU_LAYER_FUSED is on (config.layer_fused), head-major
    [B, H, T, D] otherwise: the JAX package's rule."""
    if flat is None:
        flat = batch == 1 and not int8 and layer_fused()
    return kvc.init_cache(cfg.n_layer, batch, cfg.n_head,
                          max_len or cfg.n_ctx, cfg.head_dim, dtype=dtype,
                          int8=int8, flat=flat,
                          device=resolve_device(device))
