"""Q4_0 and Q8_0 quantize / dequantize (port of ggmlsharp_tpu/quant/quantize.py).

Bit-exact with the JAX package and with upstream ggml:

  * Q4_0: ``d = signed_absmax / -8`` in f32; ``q = clip(floor(x·(1/d) + 8.5),
    0, 15)`` with that f32 d; the stored scale is ``d`` rounded to f16 and
    dequantization uses the stored f16 scale.
  * Q8_0: ``d = amax / 127``; ``q = round_half_away(x·(1/d))``.
  * ``1/d`` is 0 where d is 0 (an all-zero block).

Dequantization returns float32.
"""
from __future__ import annotations

import torch

from ..dtypes import GType
from .formats import QTensor, _check_format

F32 = torch.float32


def _blocks(x, bs=32):
    *lead, n = x.shape
    if n % bs:
        raise ValueError(f"last axis {n} is not a multiple of {bs}")
    return x.to(F32).reshape(*lead, n // bs, bs)


def _safe_inv(d):
    nz = d != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def _signed_absmax(b):
    """The value of largest magnitude in each block, sign kept (the first
    one on ties, as ggml's scan and jnp.argmax)."""
    idx = torch.argmax(b.abs(), dim=-1, keepdim=True)
    return torch.gather(b, -1, idx)[..., 0]


def quantize_row_q4_0(x) -> QTensor:
    b = _blocks(x)
    d = _signed_absmax(b) / -8.0
    iq = torch.floor(b * _safe_inv(d)[..., None] + 8.5)
    q = torch.clamp(iq, 0, 15).to(torch.uint8)
    qs = q[..., :16] | (q[..., 16:] << 4)  # ggml in-block nibble order
    return QTensor(GType.Q4_0, x.shape, {
        "qs": qs.reshape(*x.shape[:-1], x.shape[-1] // 2),
        "d": d.to(torch.float16),
    })


def dequantize_row_q4_0(qt: QTensor):
    *lead, k = qt.shape
    qs = qt["qs"].reshape(*lead, k // 32, 16)
    v = torch.cat([qs & 0xF, qs >> 4], dim=-1).to(F32) - 8.0
    return (v * qt["d"].to(F32)[..., None]).reshape(qt.shape)


def quantize_row_q8_0(x) -> QTensor:
    b = _blocks(x)
    d = b.abs().amax(dim=-1) / 127.0
    v = b * _safe_inv(d)[..., None]
    q = torch.sign(v) * torch.floor(v.abs() + 0.5)  # round half away
    qs = torch.clamp(q, -128, 127).to(torch.int8)
    return QTensor(GType.Q8_0, x.shape, {
        "qs": qs.reshape(x.shape),
        "d": d.to(torch.float16),
    })


def dequantize_row_q8_0(qt: QTensor):
    *lead, k = qt.shape
    qs = qt["qs"].reshape(*lead, k // 32, 32).to(F32)
    return (qs * qt["d"].to(F32)[..., None]).reshape(qt.shape)


_QUANTIZE = {GType.Q4_0: quantize_row_q4_0, GType.Q8_0: quantize_row_q8_0}
_DEQUANTIZE = {GType.Q4_0: dequantize_row_q4_0, GType.Q8_0: dequantize_row_q8_0}


def quantize(x, gtype) -> QTensor:
    """x [..., K] float -> QTensor of ``gtype`` (blocks along the last axis)."""
    _check_format(gtype)
    return _QUANTIZE[GType(gtype)](x)


def dequantize(qt: QTensor):
    """QTensor -> float32 tensor of its logical shape."""
    _check_format(qt.gtype)
    return _DEQUANTIZE[qt.gtype](qt)
