"""A whole llama block for one token in one launch: the CUDA kernel
``csrc/llama_layer.cu`` and its wrapper (port of
ggmlsharp_tpu/kernels/llama_layer.py::llama_layer_step).

rms1 -> qkv -> rope(q, k) -> causal attention over the cache rows ``< npast``
plus this token's fresh K/V (GQA: ``n_rep`` query heads a KV head) -> wo +
residual -> rms2 -> SwiGLU + residual, all in f32 with no activation
quantization. The block's K/V cache [T, E_kv] is read only; the caller writes
the returned roped ``k_new`` and ``v_new`` to row ``npast``. Row ``npast`` of
the cache is stale and never attended; rows ``>= T`` do not exist, so
``npast > T`` attends all T rows and the fresh one. The norm gains are f32
and applied as ``x·rsqrt(mean(x²)+eps)·g`` in f32.

Everything is in element order, and ``wqkv``, ``w_gate_up`` and ``w_down``
are read in the block's one Q4_0 copy (``fuse_llama_layer`` shares the
QTensors it is given): the JAX package's wire order, its
attn-space lanes, one-hot head dots and K-padded ``w_down`` exist for the TPU
only. One thing of that packing is part of the function, though: the JAX
block route does not use the block's ``wo``. It quantizes a second copy from
f32 with the columns regrouped (``wo[:, colperm]``, Q4_0 blocks of 32
consecutive regrouped columns), so its scales and roundings differ from the
standard ``wo``'s. ``fuse_llama_layer`` makes the same matrix, bit for bit,
and the kernel feeds attention output element ``e`` to its column
``slot[e] = argsort(colperm)[e]``. ``a2e_map`` and ``q4_korder_perm`` are
copies of the JAX package's index helpers, kept for ``colperm`` alone.

The kernel is one persistent CTA an SM that streams its share of the five
weight matrices through a ring in shared memory across the phase boundaries
(``csrc/llama_layer.cu``); its grid barrier and per-KV-head arrival
counters live in a small int32 buffer kept for each (device, stream)
(``_sync.sync_buffer``, shared with the GPT-2 block kernel), zeroed once and
left as found by every launch, so a CUDA graph that captured its address
stays valid.

The plain version is ``_layer_ref``. The wrapper runs it for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dtypes import GType
from ..ops.attention import NEG_INF
from ..ops.basic import silu
from ..ops.matmul import mul_mat_q
from ..quant.formats import QTensor, concat_qtensors
from ..quant.quantize import dequantize, quantize
from . import _build
from ._sync import MAX_HEADS, sync_buffer
from .config import use_kernel

_TILE_BYTES = 9 * 1024 * 1024
_CHUNKS = 8  # attention partials a head (csrc/llama_layer.cu CHUNKS)


def _pick_tile(n: int, kc: int) -> int:
    for t in (512, 384, 256, 128):
        if n % t == 0 and 6 * kc * t <= _TILE_BYTES:
            return t
    return 0


def _down_chunks_ok(kp: int, t: int) -> bool:
    for nc in range(1, kp // 512 + 2):
        if kp % nc:
            continue
        kc = kp // nc
        if (nc == 1 or kc % 512 == 0) and kc % 64 == 0 \
                and 6 * kc * t <= _TILE_BYTES:
            return True
    return False


def llama_layer_fuse_supported(cfg) -> bool:
    """Whether cfg's blocks take the whole-block route. This is the JAX
    package's gate (its kernel's tile and alignment limits), kept so that
    both packages take the same route on the same config; the CUDA kernel
    itself needs less (E and F multiples of 32, head_dim a multiple of 32 up
    to 128)."""
    E, F = cfg.n_embd, cfg.n_ff
    Ekv = cfg.n_head_kv * cfg.head_dim
    if cfg.n_head % cfg.n_head_kv or cfg.head_dim % 2:
        return False
    if E % 256 or Ekv % 256:
        return False
    kp = -(-F // 512) * 512
    if not _down_chunks_ok(kp, 256):
        return False
    return all((_pick_tile(E + 2 * Ekv, E), _pick_tile(E, E),
                _pick_tile(2 * kp, E)))


def a2e_map(E: int, D: int, mode: int) -> np.ndarray:
    """The JAX package's attn-space position -> head-major element map: both
    halves pair rope partners at +E/2; mode 0 pairs (2t, 2t+1), mode 2
    (t, t+D/2)."""
    half = E // 2
    p = np.arange(half)
    h = p // (D // 2)
    t = p % (D // 2)
    if mode == 2:
        first, second = h * D + t, h * D + t + D // 2
    else:
        first, second = h * D + 2 * t, h * D + 2 * t + 1
    return np.concatenate([first, second])


def q4_korder_perm(k: int) -> np.ndarray:
    """The JAX package's combined [lo; hi] 4-bit activation order: position
    i < k/2 holds element 32·(i mod C) + 2·(i // C), C = k/32; position
    i + k/2 the element after it."""
    cc = k // 32
    i = np.arange(k // 2)
    lo = 32 * (i % cc) + 2 * (i // cc)
    return np.concatenate([lo, lo + 1])


def wo_colperm(cfg) -> np.ndarray:
    """colperm [E]: column j of the block route's ``wo`` is column
    ``colperm[j]`` of the model's."""
    E, D = cfg.n_embd, cfg.head_dim
    n_rep = cfg.n_head // cfg.n_head_kv
    a2e_kv = a2e_map(cfg.n_head_kv * D, D, cfg.rope_mode)
    a2e = np.concatenate([(a2e_kv // D * n_rep + r) * D + a2e_kv % D
                          for r in range(n_rep)])
    return a2e[np.argsort(q4_korder_perm(E))]


def fuse_llama_layer(blk_raw: dict, cfg) -> dict:
    """Everything the whole-block route reads of one block. blk_raw needs
    wq/wk/wv (or wqkv), wo, w_gate/w_up (or w_gate_up), w_down, attn_norm,
    ffn_norm; a weight is a float tensor, quantized to Q4_0 here, or a Q4_0
    QTensor, which is shared and not copied (w_down stays dense in a model
    whose n_ff is no multiple of 256, while this route always reads it as
    Q4_0). Returns ``wqkv``, ``w_gate_up``, ``w_down``; ``wo``, the
    regrouped-column Q4_0 copy of ``blk_raw["wo"]`` (from f32; a Q4_0
    QTensor is dequantized first); ``slot`` int32 [E], the column of that
    copy which attention output element e feeds; ``g1``, ``g2``, the norm
    gains in f32."""

    def qt(w):
        return w if isinstance(w, QTensor) \
            else quantize(w.to(torch.float32), GType.Q4_0)

    def rows(fused_key, *keys):
        if fused_key in blk_raw:
            return qt(blk_raw[fused_key])
        return concat_qtensors([qt(blk_raw[k]) for k in keys])

    wo = blk_raw["wo"]
    wo = dequantize(wo) if isinstance(wo, QTensor) else wo.to(torch.float32)
    colperm = wo_colperm(cfg)
    dev = wo.device
    cols = torch.from_numpy(colperm).to(dev)
    return {
        "wqkv": rows("wqkv", "wq", "wk", "wv"),
        "w_gate_up": rows("w_gate_up", "w_gate", "w_up"),
        "w_down": qt(blk_raw["w_down"]),
        "wo": quantize(wo[:, cols], GType.Q4_0),
        "slot": torch.from_numpy(np.argsort(colperm).astype(np.int32)).to(dev),
        "g1": blk_raw["attn_norm"].to(torch.float32).contiguous(),
        "g2": blk_raw["ffn_norm"].to(torch.float32).contiguous(),
    }


def rope_vectors(npast, cfg):
    """cos, sin f32 [D/2] of the rotation at position ``npast`` (an int
    tensor, read on its device): ``ops.rope``'s own values, made once a
    decode step and handed to every block call."""
    half = cfg.head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=npast.device) * 2.0 / cfg.head_dim
    theta = npast.reshape(()).to(torch.float32) \
        * torch.pow(float(cfg.rope_base), exps)
    return torch.cos(theta), torch.sin(theta)


def _rotate(v, cos, sin, mode: int):
    """v [H, D] -> rope at one position (cos, sin [D/2])."""
    if mode & 2:
        half = v.shape[-1] // 2
        x1, x2 = v[..., :half], v[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    x1, x2 = v[..., 0::2], v[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(v.shape)


def _rms(x, g, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def _layer_ref(blk, x, k_cache, v_cache, npast, cfg, rope=None):
    """Plain version. x [1, E]; k_cache/v_cache [T, E_kv]; npast an int
    tensor (no host read) -> (y [1, E], k_new, v_new [1, E_kv]), f32."""
    f32 = torch.float32
    fused = blk["layer_fused"]
    E, D, Hkv = cfg.n_embd, cfg.head_dim, cfg.n_head_kv
    n_rep = cfg.n_head // Hkv
    Ekv = Hkv * D
    T = k_cache.shape[0]
    cos, sin = rope if rope is not None else rope_vectors(npast, cfg)

    def mm(w, v):
        return mul_mat_q(w, v, quantize_acts=False)

    x = x.to(f32).reshape(1, E)
    qkv = mm(fused["wqkv"], _rms(x, fused["g1"], cfg.rms_eps))
    q = _rotate(qkv[0, :E].reshape(cfg.n_head, D), cos, sin, cfg.rope_mode)
    k_new = _rotate(qkv[0, E:E + Ekv].reshape(Hkv, D), cos, sin,
                    cfg.rope_mode)
    v_new = qkv[0, E + Ekv:].reshape(Hkv, D)
    qg = (q * (1.0 / D ** 0.5)).reshape(Hkv, n_rep, D)
    kh = k_cache.to(f32).reshape(T, Hkv, D)
    vh = v_cache.to(f32).reshape(T, Hkv, D)
    s = torch.einsum("grd,tgd->grt", qg, kh)
    live = torch.arange(T, device=x.device) < npast.reshape(())
    s = torch.where(live[None, None, :], s, torch.full_like(s, NEG_INF))
    s_new = (qg * k_new[:, None, :]).sum(-1, keepdim=True)
    p = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    a = torch.einsum("grt,tgd->grd", p[..., :T], vh) \
        + p[..., T:] * v_new[:, None, :]
    a_cols = torch.empty((1, E), dtype=f32, device=x.device)
    a_cols[0, fused["slot"].long()] = a.reshape(E)
    x2 = x + mm(fused["wo"], a_cols)
    gu = mm(fused["w_gate_up"], _rms(x2, fused["g2"], cfg.rms_eps))
    y = x2 + mm(fused["w_down"], silu(gu[:, :cfg.n_ff]) * gu[:, cfg.n_ff:])
    return y, k_new.reshape(1, Ekv), v_new.reshape(1, Ekv)


def llama_layer_step(blk, x, k_cache, v_cache, npast, cfg, rope=None):
    """One decode step through one block. blk: the block's parameters, of
    which ``layer_fused`` (fuse_llama_layer) is read; x f32 [1, E];
    k_cache/v_cache [T, E_kv], the cache's first T rows (bf16 or f32); npast: an int tensor on x's
    device; rope: rope_vectors(npast, cfg) where the caller made it already
    (once for all blocks). Returns (y [1, E], k_new, v_new [1, E_kv]), f32;
    k_new is rotated."""
    if not use_kernel(x):
        return _layer_ref(blk, x, k_cache, v_cache, npast, cfg, rope)
    fused = blk.get("layer_fused")
    if fused is None:
        raise ValueError("llama_layer_step: the block has no layer_fused "
                         "(quantize_params with layer_fused=True and cfg)")
    ws = (fused["wqkv"], fused["wo"], fused["w_gate_up"], fused["w_down"])
    if not all(isinstance(w, QTensor) and w.gtype == GType.Q4_0 for w in ws):
        raise TypeError("llama_layer_step: the four weights must be Q4_0")
    E, D, F = cfg.n_embd, cfg.head_dim, cfg.n_ff
    H, Hkv = cfg.n_head, cfg.n_head_kv
    Ekv = Hkv * D
    T = k_cache.shape[0]
    if [w.shape for w in ws] != [(E + 2 * Ekv, E), (E, E), (2 * F, E), (E, F)]:
        raise ValueError(f"llama_layer_step: weight shapes "
                         f"{[w.shape for w in ws]} for E {E}, E_kv {Ekv}, "
                         f"F {F}")
    if E != H * D or H % Hkv or D % 32 or D > 128 or E % 32 or F % 32 \
            or Hkv > MAX_HEADS:
        raise ValueError(f"llama_layer_step: E {E}, heads {H}/{Hkv}, F {F}")
    if tuple(x.shape) != (1, E) or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError(f"llama_layer_step: x {tuple(x.shape)} {x.dtype}")
    if k_cache.shape != (T, Ekv) or v_cache.shape != (T, Ekv) \
            or k_cache.dtype != v_cache.dtype \
            or k_cache.dtype not in (torch.bfloat16, torch.float32) \
            or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("llama_layer_step: cache rows must be contiguous "
                         "[T, E_kv] bf16 or f32")
    cos, sin = rope if rope is not None else rope_vectors(npast, cfg)
    vecs = (cos, sin, fused["g1"], fused["g2"])
    if [tuple(v.shape) for v in vecs] != [(D // 2,)] * 2 + [(E,)] * 2 \
            or any(v.dtype != torch.float32 or not v.is_contiguous()
                   for v in vecs):
        raise ValueError("llama_layer_step: cos/sin [D/2] and gains [E] must "
                         "be contiguous f32")
    slot = fused["slot"]
    if tuple(slot.shape) != (E,) or slot.dtype != torch.int32 \
            or not slot.is_contiguous():
        raise ValueError("llama_layer_step: slot must be int32 [E]")
    np32 = npast if npast.dtype == torch.int32 and npast.dim() == 1 \
        else npast.to(torch.int32).reshape(1)
    if np32.numel() != 1:
        raise ValueError("llama_layer_step: npast must hold one integer")
    planes = [w[p] for w in ws for p in ("qs", "d")]
    if any(t.device != x.device
           for t in (k_cache, v_cache, np32, slot, *vecs, *planes)):
        raise ValueError("llama_layer_step: inputs must be on one CUDA device")
    if not all(p.is_contiguous() for p in planes) \
            or any(w["qs"].data_ptr() % 16 or w["d"].data_ptr() % 4
                   for w in ws):
        raise ValueError("llama_layer_step: weights must be contiguous, qs "
                         "16-byte and d 4-byte aligned")
    # one buffer: y [E], qkv [E + 2 E_kv] (v_new is its last E_kv), the roped
    # k_new [E_kv], then the kernel's scratch x2 [E], act [F], attention
    # partials
    sizes = (E, E + 2 * Ekv, Ekv, E, F, H * _CHUNKS * (D + 2))
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    y, qkv, kn, x2, act, part = (buf.data_ptr() + 4 * o for o in offs[:-1])
    fn = _build.entry("llama_layer")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        sync = sync_buffer(x.device, stream)
        rc = fn(x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                np32.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                *(p.data_ptr() for p in planes),
                fused["g1"].data_ptr(), fused["g2"].data_ptr(),
                slot.data_ptr(), y, qkv, kn, part, x2, act, sync.data_ptr(),
                E, H, Hkv, F, T, float(cfg.rms_eps),
                int(k_cache.dtype == torch.bfloat16), int(cfg.rope_mode),
                stream)
    _build.check("llama_layer", rc)
    v0 = offs[1] + E + Ekv
    return (buf[:E].reshape(1, E), buf[offs[2]:offs[3]].reshape(1, Ekv),
            buf[v0:v0 + Ekv].reshape(1, Ekv))
