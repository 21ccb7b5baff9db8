"""Flash attention: the CUDA kernel ``csrc/flash_attn.cu`` behind two
entries, each a ``torch.autograd.Function`` (port of
ggmlsharp_tpu/kernels/flash.py: ``flash_attention_cached`` with its backward
``_flash_cached_bwd``, and ``flash_attention`` with ops/attention.py's
``_flash_pallas_bwd``).

The kernel runs on the tensor cores (mma.sync, bf16 operands, f32
accumulation) and keeps the f32 function: an operand is held as bf16
planes, x = x0 + x1 + ..., each the bf16 rounding of what the earlier ones
leave: one plane for bf16 (exact), two for f16 (exact), three for f32 and
for the softmax weights P. A product takes every plane pair of order
i + j <= 2, so the terms left out are below the f32 rounding itself. Two
planes for f32 (2^-18) met the reference's bar too, but then GPT-2 behind
the INT8 serving engine, which rounds to INT8 downstream, parted from its
plain run at a near tie. A block takes up to 64 rows (every query head
of one KV head, by position) and reuses each double-buffered K/V tile
(cp.async) for all of them, two groups of warps taking every other tile
where there are two; tiles past the causal limit are skipped. At the paths' shapes it is bound
by the bytes of q, out and the kept K/V rows, and by the launch.

Plain versions, beside the kernel:
  * ``_cached_ref``: dense f32 cached causal GQA attention, softcap, the mask
    ``kpos <= npast + s`` (flash.py:199-216);
  * ``_uncached_ref``: the f32 function of the uncached entry (scores, p and
    P.V in f32; a fully masked row gives 0, as the kernel's).
An entry's forward runs the plain version for a CPU tensor and launches the
kernel, or raises, for a CUDA tensor. Its backward recomputes through the
plain version under autograd, as the JAX package does (there is no backward
kernel: the JAX package has none); when the caller's backward builds a graph
(``create_graph``) the gradients are themselves differentiable, so a
Hessian-vector product works.

Head dims: the kernel has instances for D 32, 64, 128 and 256. Any other
D <= 256 is zero-padded to the next instance (zero columns add nothing to a
score, and the output's padded columns are cut off); D > 256 raises. q, k
and v are read in their own types (f32, bf16, f16; q in f32 or the K/V
type, else widened to f32 first), from 16-byte aligned memory (an input
that is not is copied first).
"""
from __future__ import annotations

import torch

from ..ops.attention import NEG_INF
from . import _build
from .config import use_kernel

_INSTANCES = (32, 64, 128, 256)
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _cached_ref(q, k, v, npast, scale, softcap=0.0):
    """Dense f32 cached causal GQA attention. q [B, Hq, S, D], k/v
    [B, Hkv, T, D], npast int [B] -> f32 [B, Hq, S, D]."""
    B, Hq, S, D = q.shape
    Hkv, t = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    qg = q.to(torch.float32).reshape(B, Hkv, n_rep, S, D)
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)
    qpos = npast.to(device=q.device, dtype=torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=q.device)[None, :]
    mask = kpos[None, None, None, None, :] <= qpos[:, None, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrst,bgtd->bgrsd", p, v.to(torch.float32))
    return out.reshape(B, Hq, S, D)


def _uncached_ref(q, k, v, causal, n_past, scale, softcap=0.0):
    """Dense f32 attention. q [..., Sq, D], k/v [..., Sk, D] -> f32
    [..., Sq, D]; when causal, key j is seen by query i if j <= i + n_past."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.arange(sk, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None] + n_past
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1) * mask.any(-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32))


def _padded_d(D: int) -> int:
    for d in _INSTANCES:
        if D <= d:
            return d
    raise ValueError(f"flash: head dim {D} > {_INSTANCES[-1]}")


def _pad_d(t, Dp):
    return t if t.shape[-1] == Dp else torch.nn.functional.pad(
        t, (0, Dp - t.shape[-1]))


def _check_kv(k, v, q):
    """k and v: one dtype, one layout, rows of a head contiguous, batch
    stride Hkv * head stride (a prefix view along T of a longer cache)."""
    B, Hkv, T, D = k.shape
    if v.shape != k.shape or v.dtype != k.dtype or v.stride() != k.stride():
        raise ValueError("flash: k and v must match in shape, dtype and layout")
    if k.dtype not in _TYPE_CODE:
        raise TypeError(f"flash: k/v dtype {k.dtype}")
    st = k.stride()
    if st[3] != 1 or st[2] != D or st[0] != Hkv * st[1] or st[1] < T * D:
        raise ValueError(f"flash: unsupported k/v strides {st}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash: q, k and v must be on one device")
    return st[1]


def _launch(q, k, v, npast, n_past, causal, scale, softcap, counter):
    """q [B, Hq, S, D], k/v [B, Hkv, T, D] (any D <= 256; k/v a prefix view
    or contiguous) -> f32 [B, Hq, S, D] from one kernel launch, counted
    under ``counter``. npast: int [B], or None for the static n_past."""
    fn = _build.entry("flash_attn")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if Hq % Hkv or k.shape[0] != B or k.shape[-1] != D:
        raise ValueError(f"flash: q {tuple(q.shape)} k {tuple(k.shape)}")
    Dp = _padded_d(D)
    if Dp != D:
        q, k, v = _pad_d(q, Dp), _pad_d(k, Dp), _pad_d(v, Dp)
    if k.data_ptr() % 16 or v.data_ptr() % 16:  # the kernel's 16-byte loads
        k, v = k.clone(memory_format=torch.contiguous_format), \
            v.clone(memory_format=torch.contiguous_format)
    head_stride = _check_kv(k, v, q)
    if q.dtype not in (torch.float32, k.dtype):
        q = q.to(torch.float32)
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    np32 = None
    if npast is not None:
        np32 = npast.to(device=q.device, dtype=torch.int32).contiguous()
        if np32.shape != (B,):
            raise ValueError(f"flash: npast shape {tuple(np32.shape)}")
    out = torch.empty((B, Hq, S, Dp), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if np32 is None else np32.data_ptr(), int(n_past),
                out.data_ptr(), B, Hq, Hkv, S, T, Dp, head_stride,
                _TYPE_CODE[q.dtype], _TYPE_CODE[k.dtype], int(causal),
                float(scale), float(softcap), stream)
    _build.check("flash_attn", rc, counter)
    return out if Dp == D else out[..., :D].contiguous()


def _recompute_grads(ref, inputs, needs, g):
    """Gradients of ``ref`` at ``inputs`` against ``g``, the plain version
    rebuilt under autograd. When the backward that called this builds a
    graph (grad mode on: a double backward), the saved inputs are used as
    they are and the gradients keep their graph; otherwise the inputs are
    detached."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = [t if create else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
        out = ref(*xs)
        wrt = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad(out, wrt, g, create_graph=create,
                                       allow_unused=True))
    return [next(got) if n else None for n in needs]


class _FlashCached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, npast, scale, softcap):
        ctx.save_for_backward(q, k, v, npast)
        ctx.scale, ctx.softcap = scale, softcap
        if use_kernel(q):
            return _launch(q, k, v, npast, 0, True, scale, softcap,
                           "flash_attn")
        return _cached_ref(q, k, v, npast, scale, softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v, npast = ctx.saved_tensors
        grads = _recompute_grads(
            lambda a, b, c: _cached_ref(a, b, c, npast, ctx.scale,
                                        ctx.softcap),
            (q, k, v), ctx.needs_input_grad[:3], g)
        return (*grads, None, None, None)


class _FlashUncached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, n_past, scale, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, n_past, scale, softcap)
        if not use_kernel(q):
            return _uncached_ref(q, k, v, *ctx.args).to(q.dtype)
        lead, (sq, D), sk = q.shape[:-2], q.shape[-2:], k.shape[-2]
        if k.shape[:-2] != lead or k.shape[-1] != D or v.shape != k.shape:
            raise ValueError(f"flash: q {tuple(q.shape)} k {tuple(k.shape)} "
                             f"v {tuple(v.shape)}")
        if q.numel() == 0 or sk == 0:
            raise ValueError("flash: empty q or k")
        kv_dt = torch.promote_types(k.dtype, v.dtype)
        k3 = k.to(kv_dt).reshape(-1, 1, sk, D).contiguous()
        v3 = v.to(kv_dt).reshape(-1, 1, sk, D).contiguous()
        out = _launch(q.reshape(-1, 1, sq, D), k3, v3, None, n_past, causal,
                      scale, softcap, "flash_attn_uncached")
        return out.reshape(*lead, sq, D).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = _recompute_grads(
            lambda a, b, c: _uncached_ref(a, b, c, *ctx.args).to(a.dtype),
            (q, k, v), ctx.needs_input_grad[:3], g)
        return (*grads, None, None, None, None)


def flash_attention_cached(q, k, v, npast, scale: float | None = None,
                           softcap: float = 0.0):
    """q [B, Hq, S, D] (new tokens), k/v [B, Hkv, T, D] (the cache prefix,
    Hq = Hkv * n_rep), npast int [B] (tokens already cached: query s sits at
    position npast[b] + s) -> f32 [B, Hq, S, D]. Differentiable in q, k, v."""
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _FlashCached.apply(q, k, v, npast, float(sc), float(softcap))


def flash_attention(q, k, v, causal: bool = True, n_past: int = 0,
                    scale: float | None = None, softcap: float = 0.0):
    """q [..., Sq, D], k/v [..., Sk, D] -> [..., Sq, D] in q's dtype (f32
    compute). causal: key j is seen by query i when j <= i + n_past.
    Differentiable in q, k, v."""
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _FlashUncached.apply(q, k, v, bool(causal), int(n_past),
                                float(sc), float(softcap))
