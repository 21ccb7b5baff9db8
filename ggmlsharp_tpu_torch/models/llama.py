"""Llama family (port of ggmlsharp_tpu/models/llama.py; head-major or flat
KV cache, float or INT8).

RMSNorm pre-norm, rotary embeddings (ggml interleaved mode by default),
SwiGLU MLP, optional GQA. Parameters are plain dicts that mirror the JAX
tree; after ``quantize_params`` the blocks hold the fused ``wqkv`` and
``w_gate_up`` rows, as the JAX package's default fused layout does;
``forward`` also takes ``init_params``' separate float weights, the layout
training differentiates (the per-op loop over a head-major float cache).
Weight leaves are tensors or QTensors of any block format
(``synthetic_params`` draws a tree in one on the card).

dtype flow, as in the JAX package: embeddings and norms are bf16; the first
residual add (bf16 + f32 matmul output) promotes the stream to f32.

Two opt-in fused routes, off by default as in the JAX package
(``quantize_params(..., mlp_fused=, layer_fused=, cfg=)`` or the
environment names in ``config``):
  * ``mlp_fused``: a block's MLP of up to 64 rows (every decode step, short
    prefills) is one ``kernels.mlp_fused.flash_ff_silu_q4`` call; the gated
    product is not re-quantized before ``w_down``;
  * ``layer_fused``: a b = 1 decode step over a flat float cache is one
    ``kernels.llama_layer.llama_layer_step`` call a block
    (``_forward_llama_fused``), with no activation quantized anywhere and its
    own re-quantized ``wo``. Every other call keeps the per-op loop and the
    standard ``wo``; the cache stays in element order on both.
So fused and unfused logits differ by design.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import config
from ..device import resolve_device
from ..dtypes import GType
from ..ops import get_rows, rms_norm, rope, silu
from ..quant.formats import QTensor, concat_qtensors
from ..kernels.llama_layer import (_layer_ref, fuse_llama_layer,
                                   llama_layer_fuse_supported,
                                   llama_layer_step, rope_vectors, wo_colperm)
from ..kernels.mlp_fused import (_MAX_FUSED_B, _ff_silu_ref, flash_ff_silu_q4,
                                 mlp_silu_fuse_supported)
from ..quant.quantize import quantize
from . import kv_cache as kvc
from .common import cached_attention, linear, merge_heads, split_heads
from .common import params_from_jax  # noqa: F401  (llama.params_from_jax)


@dataclass(frozen=True)
class LlamaConfig:
    n_vocab: int = 32000
    n_ctx: int = 2048
    n_embd: int = 4096
    n_head: int = 32
    n_head_kv: int = 32  # < n_head: GQA
    n_layer: int = 32
    n_ff: int = 11008
    rms_eps: float = 1e-6
    rope_base: float = 10000.0
    rope_mode: int = 0  # 0 = ggml interleaved, 2 = NeoX halves
    tie_lm_head: bool = False

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @property
    def supports_flat_kv(self):  # forward handles the flat [B, T, E] cache
        return True


LLAMA_7B = LlamaConfig()
LLAMA_13B = LlamaConfig(n_embd=5120, n_head=40, n_head_kv=40, n_layer=40,
                        n_ff=13824)
TINY_LLAMA = LlamaConfig(  # test-scale config
    n_vocab=256, n_ctx=128, n_embd=128, n_head=4, n_head_kv=2, n_layer=2,
    n_ff=256)

PAD_ROWS = 256  # embedding / LM-head rows are padded to this (logits sliced)


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.bfloat16):
    """Random bf16 weights, N(0, 0.02), unit norms. ``generator`` must live on
    ``device``; None means a fresh one seeded with 0."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(0)
    hd = cfg.head_dim

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def ones():
        return torch.ones(cfg.n_embd, dtype=dtype, device=dev)

    return {
        "tok_embd": w(cfg.n_vocab, cfg.n_embd),
        "norm": ones(),
        "output": None if cfg.tie_lm_head else w(cfg.n_vocab, cfg.n_embd),
        "blocks": [
            {
                "attn_norm": ones(),
                "wq": w(cfg.n_head * hd, cfg.n_embd),
                "wk": w(cfg.n_head_kv * hd, cfg.n_embd),
                "wv": w(cfg.n_head_kv * hd, cfg.n_embd),
                "wo": w(cfg.n_embd, cfg.n_head * hd),
                "ffn_norm": ones(),
                "w_gate": w(cfg.n_ff, cfg.n_embd),
                "w_up": w(cfg.n_ff, cfg.n_embd),
                "w_down": w(cfg.n_embd, cfg.n_ff),
            }
            for _ in range(cfg.n_layer)
        ],
    }


def fuse_params(params):
    """wq/wk/wv -> wqkv and w_gate/w_up -> w_gate_up (row concat: one matmul
    instead of three and two, bit-identical values)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = []
    for b in params["blocks"]:
        nb = {k: v for k, v in b.items()
              if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
        nb["wqkv"] = concat_qtensors([b["wq"], b["wk"], b["wv"]])
        nb["w_gate_up"] = concat_qtensors([b["w_gate"], b["w_up"]])
        out["blocks"].append(nb)
    return out


def _mark_mlp_fused(blocks):
    """Mark the blocks whose MLP pair passes the fused SwiGLU kernel's gate.
    The kernel reads the block's own w_gate_up and w_down: no copy."""
    for blk in blocks:
        if mlp_silu_fuse_supported(blk.get("w_gate_up"), blk.get("w_down")):
            blk["mlp_fused"] = True


def quantize_params(params, gtype: GType, cfg: LlamaConfig | None = None,
                    mlp_fused: bool | None = None,
                    layer_fused: bool | None = None,
                    embd_gtype: GType | None = None, search: bool = False):
    """Weight-only quantization of the 2-D weights whose rows are whole
    256-element groups, then fuse_params. The embedding and LM-head tables
    take ``embd_gtype`` (default ``gtype``, as llama.cpp's policy allows a
    different one) and their rows are padded to PAD_ROWS (forward slices the
    logits back to n_vocab). search: the k-quants' quality search.
    mlp_fused / layer_fused (None: config.mlp_fused() / config.llama_fused(),
    off by default) switch the fused routes on for Q4_0: blocks whose MLP
    pair passes mlp_silu_fuse_supported get the marker ``mlp_fused``; given
    ``cfg`` passing llama_layer_fuse_supported, each block whose raw weights
    are floats or Q4_0 gets ``layer_fused`` (kernels.llama_layer.
    fuse_llama_layer: the whole-block route's re-quantized ``wo`` beside the
    block's own Q4_0 tensors, shared)."""

    embd_gtype = embd_gtype or gtype

    def q(t, pad_rows=False):
        if t is None or isinstance(t, QTensor) or t.dim() != 2 \
                or t.shape[-1] % 256:
            return t
        if pad_rows and t.shape[0] % PAD_ROWS:
            pad = PAD_ROWS - t.shape[0] % PAD_ROWS
            t = torch.cat([t, t.new_zeros((pad, t.shape[1]))], dim=0)
        return quantize(t.to(torch.float32), embd_gtype if pad_rows else gtype,
                        search=search)

    out = {
        "tok_embd": q(params["tok_embd"], pad_rows=True),
        "norm": params["norm"],
        "output": q(params["output"], pad_rows=True),
        "blocks": [
            {k: (v if k.endswith("norm") else q(v)) for k, v in b.items()}
            for b in params["blocks"]
        ],
    }
    out = fuse_params(out)
    if gtype != GType.Q4_0:
        return out
    if config.mlp_fused() if mlp_fused is None else mlp_fused:
        _mark_mlp_fused(out["blocks"])
    if cfg is not None and llama_layer_fuse_supported(cfg) and (
            config.llama_fused() if layer_fused is None else layer_fused):

        def fusable(w):
            return w is not None and (not isinstance(w, QTensor)
                                      or w.gtype == GType.Q4_0)

        for ob, rb in zip(out["blocks"], params["blocks"]):
            if all(fusable(rb.get(n)) for n in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")):
                # the tensors quantized above are shared, not made again
                shared = {k: ob[k] for k in ("wqkv", "w_gate_up", "w_down")
                          if isinstance(ob[k], QTensor)}
                ob["layer_fused"] = fuse_llama_layer({**rb, **shared}, cfg)
    return out


def random_q4_0(n: int, k: int, generator: torch.Generator, device,
                scale: float | None = None) -> QTensor:
    """A random Q4_0 [n, k] drawn on ``device``: nibbles uniform in 1..15
    (q - 8 symmetric about 0, RMS 4.32) and f16 scales in [0.5, 1.5)·s with
    s = 1 / (4.32·sqrt(k)) by default, so a unit-RMS input row gives
    unit-RMS outputs."""
    s = scale if scale is not None else 1.0 / (4.32 * k ** 0.5)

    def nibbles():
        return torch.randint(1, 16, (n, k // 2), generator=generator,
                             device=device, dtype=torch.uint8)

    qs = nibbles() | (nibbles() << 4)
    d = ((torch.rand((n, k // 32), generator=generator, device=device) + 0.5)
         * s).to(torch.float16)
    return QTensor(GType.Q4_0, (n, k), {"qs": qs, "d": d})


def synthetic_q4_0_params(cfg: LlamaConfig, seed: int = 0, device=None,
                          mlp_fused: bool | None = None,
                          layer_fused: bool | None = None):
    """A fused Q4_0 parameter tree of random_q4_0 weights drawn directly on
    ``device`` from ``seed``, unit norms, embedding rows of RMS about 1. No
    f32 staging copy is made (at 7B it would take 27 GB). mlp_fused /
    layer_fused as in quantize_params; the whole-block route's ``wo`` copies
    are drawn after every other weight (random, as ``wo`` is; at 7B 32 x 9.4
    MB), so the rest of the tree is the same with the switch on or off. The
    projections back into the residual stream (wo, w_down) are scaled by
    1/sqrt(2·n_layer), GPT-2's residual init, so each block's update stays
    small against the stream as in a trained model; with unit-scale updates
    the 32-layer network carried rounding differences to several times
    larger logit differences."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    hd = cfg.head_dim
    E, F = cfg.n_embd, cfg.n_ff
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    vpad = -(-cfg.n_vocab // PAD_ROWS) * PAD_ROWS
    res = (2 * cfg.n_layer) ** -0.5

    def qt(n, k, scale=None):
        return random_q4_0(n, k, gen, dev, scale)

    def ones():
        return torch.ones(E, dtype=torch.bfloat16, device=dev)

    params = {
        "tok_embd": qt(vpad, E, 1.0 / 4.32),
        "norm": ones(),
        "output": qt(vpad, E),
        "blocks": [
            {
                "attn_norm": ones(),
                "wqkv": qt(nq + 2 * nkv, E),
                "wo": qt(E, nq, res / (4.32 * nq ** 0.5)),
                "ffn_norm": ones(),
                "w_gate_up": qt(2 * F, E),
                "w_down": qt(E, F, res / (4.32 * F ** 0.5)),
            }
            for _ in range(cfg.n_layer)
        ],
    }
    if config.mlp_fused() if mlp_fused is None else mlp_fused:
        _mark_mlp_fused(params["blocks"])
    if llama_layer_fuse_supported(cfg) and (
            config.llama_fused() if layer_fused is None else layer_fused):
        slot = torch.from_numpy(wo_colperm(cfg).argsort().astype("int32")
                                ).to(dev)
        for blk in params["blocks"]:
            blk["layer_fused"] = {
                "wqkv": blk["wqkv"], "w_gate_up": blk["w_gate_up"],
                "w_down": blk["w_down"],
                "wo": qt(E, nq, res / (4.32 * nq ** 0.5)), "slot": slot,
                "g1": blk["attn_norm"].to(torch.float32),
                "g2": blk["ffn_norm"].to(torch.float32)}
    return params


def synthetic_params(cfg: LlamaConfig, gtype: GType, seed: int = 0,
                     device=None):
    """A fused parameter tree in ``gtype`` (every matmul weight and both
    tables, as quantize_params gives it) from random weights drawn on
    ``device`` from ``seed``: each matrix is drawn in f32, quantized by the
    port's quantizer and freed before the next, so no f32 copy of the model
    exists (at 7B it would take 27 GB; the largest matrix, w_gate_up, is 361
    MB). Weights are N(0, 1/k) for k inputs (a unit-RMS row gives unit-RMS
    outputs), embedding rows N(0, 1); wo and w_down are scaled by
    1/sqrt(2·n_layer) as in synthetic_q4_0_params; unit norms."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    hd = cfg.head_dim
    E, F = cfg.n_embd, cfg.n_ff
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    vpad = -(-cfg.n_vocab // PAD_ROWS) * PAD_ROWS
    res = (2 * cfg.n_layer) ** -0.5

    def qt(n, k, scale=1.0):
        w = torch.randn((n, k), generator=gen, device=dev)
        return quantize(w.mul_(scale / k ** 0.5), gtype)

    def ones():
        return torch.ones(E, dtype=torch.bfloat16, device=dev)

    return {
        "tok_embd": qt(vpad, E, E ** 0.5),
        "norm": ones(),
        "output": qt(vpad, E),
        "blocks": [
            {
                "attn_norm": ones(),
                "wqkv": qt(nq + 2 * nkv, E),
                "wo": qt(E, nq, res),
                "ffn_norm": ones(),
                "w_gate_up": qt(2 * F, E),
                "w_down": qt(E, F, res),
            }
            for _ in range(cfg.n_layer)
        ],
    }


def _rms(x, g, eps):
    return rms_norm(x.to(torch.float32), eps=eps).to(x.dtype) * g


def _flat_attention(q, k, v, cache, i, positions, widx, cfg: LlamaConfig,
                    prefix_bound, cached_prefix, plain):
    """Attention of one layer over a flat [B, T, E_kv] cache (the serving
    path; llama.py:318-442 of the JAX package). Writes this call's K/V rows
    (quantized for INT8) at widx = kv_cache.flat_index of the positions, then:
      * S == 1: the attn_decode kernel over the live rows, the fresh row
        attended unquantized;
      * S <= 8 or cached_prefix: exact GQA attention over the live rows,
        dequantized (flash over a head-major copy when S > 8);
      * otherwise (prefill from an empty prefix): flash over this call's
        own fresh, unquantized K/V.
    Returns [B, S, Hq * D] in q's dtype."""
    from ..kernels.attn_decode import _decode_ref, flash_decode_flat
    from .common import _einsum_attention, _ring_unported, flash

    B, Hq, S, hd = q.shape
    Hkv = cfg.n_head_kv
    kn, vn = merge_heads(k), merge_heads(v)
    cache = kvc.update_layer_flat(cache, i, kn, vn, positions, widx)
    t = cache.max_len if prefix_bound is None else \
        min(int(prefix_bound), cache.max_len)
    if S == 1:
        scales = {}
        if cache.int8:
            scales = {"k_scale": cache.k_scale[i][:, :t],
                      "v_scale": cache.v_scale[i][:, :t]}
        decode = _decode_ref if plain else flash_decode_flat
        out = decode(merge_heads(q)[:, 0].reshape(B, Hq, hd), kn[:, 0],
                     vn[:, 0], cache.k[i][:, :t], cache.v[i][:, :t],
                     positions[:, 0], Hkv, hd, **scales)
        return out.reshape(B, 1, Hq * hd).to(q.dtype)
    if cached_prefix if cached_prefix is not None else S <= 8:
        # a multi-token step over a possibly non-empty prefix: the rows of
        # this call were just written (quantized for INT8) and are read
        # back with the prefix, as a head-major copy in q's dtype
        kc, vc = kvc.read_layer_flat(cache, i, t)
        k_all = kc.reshape(B, t, Hkv, hd).transpose(1, 2).to(q.dtype)
        v_all = vc.reshape(B, t, Hkv, hd).transpose(1, 2).to(q.dtype)
        if S > 8:
            a = flash(q, k_all.contiguous(), v_all.contiguous(),
                      positions[:, 0], plain)
        else:
            a = _einsum_attention(q, k_all, v_all, positions, Hq // Hkv)
    else:
        # prefill from the empty prefix over this call's fresh K/V (the JAX
        # package's GGML_TPU_ATTN=ring would shard it over a sequence mesh)
        if config.attn_impl() == "ring":
            _ring_unported()
        a = flash(q, k.contiguous(), v.contiguous(), positions[:, 0], plain)
    return merge_heads(a).to(q.dtype)


def _forward_llama_fused(params, cfg: LlamaConfig, tokens, cache, positions,
                         prefix_bound, plain):
    """One token at b = 1 through the whole-block route: one llama_layer_step
    a block, the block's new K/V row (roped k, bf16-rounded by the write)
    written to the flat cache here, after the call that read the cache and
    attended the row unrounded. The stream is f32 from the embedding row on;
    no activation is quantized, the LM head's included."""
    E = cfg.n_embd
    x = get_rows(params["tok_embd"], tokens).reshape(1, E) \
        .to(torch.float32).contiguous()
    npast = positions[0].to(torch.int32)  # [1], read on the device
    rope_cs = rope_vectors(npast, cfg)
    widx = kvc.flat_index(cache, positions)
    T = cache.max_len if prefix_bound is None else \
        min(int(prefix_bound), cache.max_len)
    step = _layer_ref if plain else llama_layer_step
    for i, blk in enumerate(params["blocks"]):
        x, kn, vn = step(blk, x, cache.k[i][0, :T], cache.v[i][0, :T], npast,
                         cfg, rope_cs)
        cache = kvc.update_layer_flat(cache, i, kn, vn, positions, widx)
    x = _rms(x, params["norm"], cfg.rms_eps)
    w_out = params["output"] if params["output"] is not None \
        else params["tok_embd"]
    logits = linear(w_out, x, quantize_acts=False, plain=plain)
    logits = logits[..., :cfg.n_vocab]
    return logits.reshape(1, 1, -1).to(torch.float32), kvc.advance(cache, 1)


def forward(params, cfg: LlamaConfig, tokens, cache: kvc.KVCache, positions,
            prefix_bound: int | None = None,
            cached_prefix: bool | None = None, plain: bool = False):
    """tokens/positions: int [B, S]. Returns (logits f32 [B, S, n_vocab],
    cache advanced by S). The cache is written in place. prefix_bound: a
    host-side bound on the live cache prefix (see sampling.length_bucket).
    cached_prefix: whether a multi-token call over a flat cache attends the
    cache's live prefix (True: needed when positions do not start at 0, as
    in prefix-cached or chunked prefill) or flash over its own fresh K/V
    only (False); None means True for S <= 8.
    plain: run the kernels' plain PyTorch versions (a card run's reference)."""
    if (cache.is_flat and tokens.shape == (1, 1) and not cache.int8
            and all("layer_fused" in b for b in params["blocks"])):
        return _forward_llama_fused(params, cfg, tokens, cache, positions,
                                    prefix_bound, plain)
    x = get_rows(params["tok_embd"], tokens)
    x = x.to(params["norm"].dtype)
    n_rep = cfg.n_head // cfg.n_head_kv
    B, S = tokens.shape
    hd = cfg.head_dim
    nq = cfg.n_head * hd
    nkv = cfg.n_head_kv * hd
    widx = kvc.flat_index(cache, positions) if cache.is_flat else None
    for i, blk in enumerate(params["blocks"]):
        h = _rms(x, blk["attn_norm"], cfg.rms_eps)
        if "wqkv" in blk:  # the fused layout (fuse_params)
            qkv = linear(blk["wqkv"], h, plain=plain)
            q = split_heads(qkv[..., :nq], cfg.n_head)
            k = split_heads(qkv[..., nq:nq + nkv], cfg.n_head_kv)
            v = split_heads(qkv[..., nq + nkv:], cfg.n_head_kv)
        else:  # init_params' separate weights (the training layout)
            q = split_heads(linear(blk["wq"], h, plain=plain), cfg.n_head)
            k = split_heads(linear(blk["wk"], h, plain=plain), cfg.n_head_kv)
            v = split_heads(linear(blk["wv"], h, plain=plain), cfg.n_head_kv)
        q = rope(q, positions, mode=cfg.rope_mode, base=cfg.rope_base)
        k = rope(k, positions, mode=cfg.rope_mode, base=cfg.rope_base)
        if cache.is_flat:
            a = _flat_attention(q, k, v, cache, i, positions, widx, cfg,
                                prefix_bound, cached_prefix, plain)
        else:
            a, cache = cached_attention(q, k, v, cache, i, positions,
                                        n_rep=n_rep,
                                        prefix_bound=prefix_bound,
                                        plain=plain)
            a = merge_heads(a)
        x = x + linear(blk["wo"], a, plain=plain)

        h = _rms(x, blk["ffn_norm"], cfg.rms_eps)
        if "mlp_fused" in blk and B * S <= _MAX_FUSED_B:
            ff = _ff_silu_ref if plain else flash_ff_silu_q4
            x = x + ff(blk["w_gate_up"], blk["w_down"], h,
                       quantize_acts=config.quantize_activations()
                       ).to(x.dtype)
        elif "w_gate_up" in blk:
            gu = linear(blk["w_gate_up"], h, plain=plain)
            gate, up = gu[..., :cfg.n_ff], gu[..., cfg.n_ff:]
            x = x + linear(blk["w_down"], silu(gate) * up, plain=plain)
        else:
            gate = silu(linear(blk["w_gate"], h, plain=plain))
            x = x + linear(blk["w_down"],
                           gate * linear(blk["w_up"], h, plain=plain),
                           plain=plain)

    x = _rms(x, params["norm"], cfg.rms_eps)
    w_out = params["output"] if params["output"] is not None \
        else params["tok_embd"]
    logits = linear(w_out, x.to(torch.float32), quantize_acts=False,
                    plain=plain)
    logits = logits[..., :cfg.n_vocab]  # drop the padding rows
    return logits.to(torch.float32), kvc.advance(cache, S)


def new_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
              int8: bool = False, max_len: int | None = None,
              flat: bool | None = None, device=None) -> kvc.KVCache:
    """A cache of T = max_len or n_ctx rows. flat=None: the flat
    [B, T, E_kv] layout (decode through the attn_decode kernel) for an
    INT8 cache whose E_kv is a multiple of 128, head-major [B, H_kv, T, D]
    otherwise: the JAX package's defaults."""
    if flat is None:
        flat = int8 and (cfg.n_head_kv * cfg.head_dim) % 128 == 0
    return kvc.init_cache(cfg.n_layer, batch, cfg.n_head_kv,
                          max_len or cfg.n_ctx, cfg.head_dim, dtype=dtype,
                          int8=int8, flat=flat,
                          device=resolve_device(device))
