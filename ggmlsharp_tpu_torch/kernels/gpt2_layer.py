"""A whole GPT-2 block for one token in one launch: the CUDA kernel
``csrc/gpt2_layer.cu`` and its wrapper (port of
ggmlsharp_tpu/kernels/gpt2_layer.py::gpt2_layer_step).

ln1 -> qkv (+ bias) -> causal attention over the cache rows ``< npast`` plus
this token's fresh K/V -> proj (+ bias, + residual) -> ln2 -> GELU fc ->
cproj (+ bias, + residual), all in f32 with no activation quantization. The
block's K/V cache [T, E] is read only; the caller writes the returned
``k_new``/``v_new`` to row ``npast``. Row ``npast`` of the cache is stale and
never attended; rows ``>= T`` do not exist, so ``npast > T`` attends all T
rows and the fresh one.

Everything is in element order and the four weights are read in the block's
one Q8_0 copy: the JAX package's wire order, permuted planes and one-hot head
reduction exist for the TPU only.

The plain version is ``_layer_ref``. The wrapper runs it for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..dtypes import GType
from ..ops.attention import NEG_INF
from ..ops.basic import gelu, norm
from ..ops.matmul import mul_mat_q
from ..quant.formats import QTensor
from . import _build

_TILE_BYTES = 9 * 1024 * 1024
_CHUNKS = 8  # attention partials a head (csrc/gpt2_layer.cu CHUNKS)


def _pick_tile(n: int, k: int) -> int:
    for t in (512, 384, 256, 128):
        if n % t == 0 and 8 * k * t <= _TILE_BYTES:
            return t
    return 0


def gpt2_layer_fuse_supported(E: int, F: int) -> bool:
    """Whether an (E, F) block takes the whole-block route. This is the JAX
    package's gate (its kernel's tile and alignment limits), kept so that
    both packages take the same route on the same config; the CUDA kernel
    itself needs less (E and F multiples of 32)."""
    return (E % 128 == 0 and F % 128 == 0
            and all((_pick_tile(3 * E, E), _pick_tile(E, E),
                     _pick_tile(F, E), _pick_tile(E, F))))


def block_fusable(blk) -> bool:
    """A block of a parameter tree whose four weights are Q8_0 and whose
    widths pass gpt2_layer_fuse_supported."""
    ws = (blk["attn"]["c_attn_w"], blk["attn"]["c_proj_w"],
          blk["mlp"]["c_fc_w"], blk["mlp"]["c_proj_w"])
    if not all(isinstance(w, QTensor) and w.gtype == GType.Q8_0 for w in ws):
        return False
    return gpt2_layer_fuse_supported(ws[1].shape[0], ws[2].shape[0])


def _vectors(blk):
    """The block's four biases and two layer-norm pairs, in the kernel's
    argument order."""
    return (blk["attn"]["c_attn_b"], blk["attn"]["c_proj_b"],
            blk["mlp"]["c_fc_b"], blk["mlp"]["c_proj_b"],
            blk["ln_1"]["g"], blk["ln_1"]["b"],
            blk["ln_2"]["g"], blk["ln_2"]["b"])


def _layer_ref(blk, x, k_cache, v_cache, npast, n_head: int, ln_eps: float):
    """Plain version. x [1, E]; k_cache/v_cache [T, E]; npast an int tensor
    (no host read) -> (y, k_new, v_new), each f32 [1, E]."""
    f32 = torch.float32
    E = x.shape[-1]
    T = k_cache.shape[0]
    D = E // n_head
    attn, mlp = blk["attn"], blk["mlp"]

    def ln(v, p):
        return norm(v, ln_eps) * p["g"].to(f32) + p["b"].to(f32)

    def mm(w, v):
        return mul_mat_q(w, v, quantize_acts=False)

    x = x.to(f32).reshape(1, E)
    qkv = mm(attn["c_attn_w"], ln(x, blk["ln_1"])) + attn["c_attn_b"].to(f32)
    q, k_new, v_new = qkv.split(E, dim=-1)
    qh = q.reshape(n_head, D) * (1.0 / D ** 0.5)
    kh = k_cache.to(f32).reshape(T, n_head, D)
    vh = v_cache.to(f32).reshape(T, n_head, D)
    s = torch.einsum("hd,thd->ht", qh, kh)
    live = torch.arange(T, device=x.device) < npast.reshape(())
    s = torch.where(live[None, :], s, torch.full_like(s, NEG_INF))
    s_new = (qh * k_new.reshape(n_head, D)).sum(-1, keepdim=True)
    p = torch.softmax(torch.cat([s, s_new], dim=1), dim=-1)
    a = torch.einsum("ht,thd->hd", p[:, :T], vh) \
        + p[:, T:] * v_new.reshape(n_head, D)
    x2 = x + mm(attn["c_proj_w"], a.reshape(1, E)) + attn["c_proj_b"].to(f32)
    h = gelu(mm(mlp["c_fc_w"], ln(x2, blk["ln_2"])) + mlp["c_fc_b"].to(f32))
    y = x2 + mm(mlp["c_proj_w"], h) + mlp["c_proj_b"].to(f32)
    return y, k_new, v_new


def gpt2_layer_step(blk, x, k_cache, v_cache, npast, n_head: int,
                    ln_eps: float):
    """One decode step through one block. blk: the block's parameters
    (ln_1, attn, ln_2, mlp; Q8_0 weights); x f32 [1, E]; k_cache/v_cache
    [T, E], the cache's first T rows (bf16 or f32); npast: an int tensor on
    x's device. Returns (y, k_new, v_new), each f32 [1, E]."""
    if not x.is_cuda:
        return _layer_ref(blk, x, k_cache, v_cache, npast, n_head, ln_eps)
    attn, mlp = blk["attn"], blk["mlp"]
    ws = (attn["c_attn_w"], attn["c_proj_w"], mlp["c_fc_w"], mlp["c_proj_w"])
    if not all(isinstance(w, QTensor) and w.gtype == GType.Q8_0 for w in ws):
        raise TypeError("gpt2_layer_step: the four weights must be Q8_0")
    E = x.shape[-1]
    F = ws[2].shape[0]
    T = k_cache.shape[0]
    if [w.shape for w in ws] != [(3 * E, E), (E, E), (F, E), (E, F)]:
        raise ValueError(f"gpt2_layer_step: weight shapes "
                         f"{[w.shape for w in ws]} for E {E}")
    if E % n_head or (E // n_head) % 32 or E // n_head > 128 or F % 32:
        raise ValueError(f"gpt2_layer_step: E {E}, heads {n_head}, F {F}")
    if tuple(x.shape) != (1, E) or x.dtype != torch.float32 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"gpt2_layer_step: x {tuple(x.shape)} {x.dtype}")
    if k_cache.shape != (T, E) or v_cache.shape != (T, E) \
            or k_cache.dtype != v_cache.dtype \
            or k_cache.dtype not in (torch.bfloat16, torch.float32) \
            or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("gpt2_layer_step: cache rows must be contiguous "
                         "[T, E] bf16 or f32")
    vecs = _vectors(blk)
    want = [(3 * E,), (E,), (F,), (E,)] + [(E,)] * 4
    if [tuple(v.shape) for v in vecs] != want:
        raise ValueError("gpt2_layer_step: bias or layer-norm shapes")
    if len({v.dtype for v in vecs}) != 1 \
            or vecs[0].dtype not in (torch.float32, torch.bfloat16):
        vecs = tuple(v.to(torch.float32) for v in vecs)
    vecs = tuple(v if v.is_contiguous() else v.contiguous() for v in vecs)
    np32 = npast if npast.dtype == torch.int32 and npast.dim() == 1 \
        else npast.to(torch.int32).reshape(1)
    if np32.numel() != 1:
        raise ValueError("gpt2_layer_step: npast must hold one integer")
    planes = [w[p] for w in ws for p in ("qs", "d")]
    if any(t.device != x.device
           for t in (k_cache, v_cache, np32, *vecs, *planes)):
        raise ValueError("gpt2_layer_step: inputs must be on one CUDA device")
    if not all(p.is_contiguous() for p in planes) \
            or any(w["qs"].data_ptr() % 16 for w in ws):
        raise ValueError("gpt2_layer_step: weights must be contiguous and "
                         "16-byte aligned")
    # one buffer: y [E], qkv [3E] (k_new, v_new are its thirds), then the
    # kernel's scratch x2 [E], h [F], attention partials
    n_part = n_head * _CHUNKS * (E // n_head + 2)
    buf = torch.empty(5 * E + F + n_part, dtype=torch.float32,
                      device=x.device)
    base = buf.data_ptr()
    y, qkv = base, base + 4 * E
    x2, h, part = base + 16 * E, base + 20 * E, base + 20 * E + 4 * F
    (qa, da), (qp, dp), (qf, df), (qc, dc) = (
        (w["qs"].data_ptr(), w["d"].data_ptr()) for w in ws)
    ba, bp, bf, bc, g1, b1, g2, b2 = (v.data_ptr() for v in vecs)
    fn = _build.entry("gpt2_layer")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                np32.data_ptr(), qa, da, ba, qp, dp, bp, qf, df, bf,
                qc, dc, bc, g1, b1, g2, b2, y, qkv, part, x2, h,
                E, n_head, F, T, float(ln_eps),
                int(k_cache.dtype == torch.bfloat16),
                int(vecs[0].dtype == torch.bfloat16), stream)
    _build.check("gpt2_layer", rc)
    return (buf[:E].reshape(1, E), buf[2 * E:3 * E].reshape(1, E),
            buf[3 * E:4 * E].reshape(1, E))
