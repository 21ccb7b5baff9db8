"""quantize / dequantize for every block format (port of
ggmlsharp_tpu/quant/quantize.py).

Bit-exact with the JAX package, and so with upstream ggml where the golden
oracle speaks (same f32 arithmetic in the same order, same rounding):

  * Q4_0 / Q4_2 (32 / 16-element blocks): ``d = signed_absmax / -8`` in
    f32; ``q = clip(floor(x·(1/d) + 8.5), 0, 15)`` with that f32 d; the
    stored scale is ``d`` rounded to f16.
  * Q4_1 / Q4_3: affine, ``d = (max - min) / 15``, ``q = floor((x - min)·
    (1/d) + 0.5)``; d and min stored as f16.
  * Q5_0 / Q5_1: as Q4_0 / Q4_1 with 5-bit values (``/ -16``, ``/ 31``);
    the fifth bits go to the per-block ``qh`` mask.
  * Q8_0: ``d = amax / 127``; ``q = round_half_away(x·(1/d))``. Q8_1: the
    same with f32 d and ``s = d·Σq``. Q8_K: 256-element blocks, f32 d,
    int16 sums of 16 quants.
  * Q4_K: 8 sub-blocks of 32, min/max fit (or, with ``search=True``, the
    weighted make_qkx2_quants-style grid search), 6-bit sub-block scales
    and mins against f16 d and dmin. Q6_K: 16 sub-blocks of 16, signed
    6-bit values, int8 sub-block scales against f16 d (``search=True``: the
    make_qx_quants-style signed scale search).
  * ``1/d`` is 0 where d is 0 (an all-zero block).

Dequantization returns float32. ``dequantize`` is exact; ``fused_scales=
True`` gives the k-quants the matmul kernels' weights instead: sub-block
scale ``kd = f16(d·sc)`` and min ``km = f16(dmin·m)`` rounded to f16 once,
as the JAX package's TPU kernels read them (up to 2^-11 relative from the
exact ``d·sc``). The other formats have one function.
"""
from __future__ import annotations

import torch

from ..dtypes import GType
from .formats import QTensor, _check_format

F32 = torch.float32


def _blocks(x, bs):
    *lead, n = x.shape
    if n % bs:
        raise ValueError(f"last axis {n} is not a multiple of {bs}")
    return x.to(F32).reshape(*lead, n // bs, bs)


def _safe_inv(d):
    nz = d != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def _div(a, b):
    """a / b as an f32 division on every device, a or b a Python number.
    PyTorch takes ``t / number`` on the card, and ``number / t`` anywhere,
    as a product with a reciprocal, which can differ in the last bit."""
    ref = a if torch.is_tensor(a) else b
    return (a if torch.is_tensor(a) else torch.full_like(ref, a)) \
        / (b if torch.is_tensor(b) else torch.full_like(ref, b))


def _signed_absmax(b):
    """The value of largest magnitude in each block, sign kept (the first
    one on ties, as ggml's scan and jnp.argmax)."""
    idx = torch.argmax(b.abs(), dim=-1, keepdim=True)
    return torch.gather(b, -1, idx)[..., 0]


def _round_half_away(v):
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


def _pack_nibbles(q):
    """(..., nb, B) ints in [0, 15] -> uint8 (..., nb·B/2): byte j of a
    block holds element j (low nibble) and element j + B/2 (high)."""
    h = q.shape[-1] // 2
    return (q[..., :h] | (q[..., h:] << 4)).to(torch.uint8).flatten(-2)


def _unpack_nibbles(qs, bs):
    """Inverse of _pack_nibbles -> int32 (..., nb, bs)."""
    b = qs.reshape(*qs.shape[:-1], qs.shape[-1] * 2 // bs, bs // 2).to(
        torch.int32)
    return torch.cat([b & 0xF, b >> 4], dim=-1)


def _to_int32(v):
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _qh_pack(q):
    """(..., nb, 32) 5-bit values -> int32 (..., nb): bit l is element l's
    fifth bit."""
    hb = ((q >> 4) & 1).to(torch.int64)
    sh = torch.arange(32, device=q.device, dtype=torch.int64)
    return _to_int32((hb << sh).sum(dim=-1))


def _qh_unpack(qh):
    sh = torch.arange(32, device=qh.device, dtype=torch.int32)
    return (qh[..., None] >> sh) & 1


# --- Q4_0 / Q4_2 (signed absmax, offset nibbles) -------------------------

def _quantize_q4_sym(gtype, x, bs):
    b = _blocks(x, bs)
    d = _div(_signed_absmax(b), -8.0)
    iq = torch.floor(b * _safe_inv(d)[..., None] + 8.5)
    q = torch.clamp(iq, 0, 15).to(torch.int32)
    return QTensor(gtype, x.shape, {"d": d.to(torch.float16),
                                    "qs": _pack_nibbles(q)})


def _dequantize_q4_sym(qt, bs):
    v = _unpack_nibbles(qt["qs"], bs).to(F32) - 8.0
    return (v * qt["d"].to(F32)[..., None]).reshape(qt.shape)


def quantize_row_q4_0(x) -> QTensor:
    return _quantize_q4_sym(GType.Q4_0, x, 32)


def dequantize_row_q4_0(qt: QTensor):
    return _dequantize_q4_sym(qt, 32)


def quantize_row_q4_2(x) -> QTensor:
    return _quantize_q4_sym(GType.Q4_2, x, 16)


def dequantize_row_q4_2(qt: QTensor):
    return _dequantize_q4_sym(qt, 16)


# --- Q4_1 / Q4_3 (affine min/max nibbles) --------------------------------

def _quantize_q4_aff(gtype, x, bs):
    b = _blocks(x, bs)
    mn = b.amin(dim=-1)
    d = _div(b.amax(dim=-1) - mn, 15.0)
    iq = torch.floor((b - mn[..., None]) * _safe_inv(d)[..., None] + 0.5)
    q = torch.clamp(iq, 0, 15).to(torch.int32)
    return QTensor(gtype, x.shape, {"d": d.to(torch.float16),
                                    "m": mn.to(torch.float16),
                                    "qs": _pack_nibbles(q)})


def _dequantize_q4_aff(qt, bs):
    v = _unpack_nibbles(qt["qs"], bs).to(F32)
    return (v * qt["d"].to(F32)[..., None]
            + qt["m"].to(F32)[..., None]).reshape(qt.shape)


def quantize_row_q4_1(x) -> QTensor:
    return _quantize_q4_aff(GType.Q4_1, x, 32)


def dequantize_row_q4_1(qt: QTensor):
    return _dequantize_q4_aff(qt, 32)


def quantize_row_q4_3(x) -> QTensor:
    return _quantize_q4_aff(GType.Q4_3, x, 16)


def dequantize_row_q4_3(qt: QTensor):
    return _dequantize_q4_aff(qt, 16)


# --- Q5_0 / Q5_1 (nibbles + per-block high-bit mask) ---------------------

def quantize_row_q5_0(x) -> QTensor:
    b = _blocks(x, 32)
    d = _div(_signed_absmax(b), -16.0)
    iq = torch.floor(b * _safe_inv(d)[..., None] + 16.5)
    q = torch.clamp(iq, 0, 31).to(torch.int32)
    return QTensor(GType.Q5_0, x.shape, {"d": d.to(torch.float16),
                                         "qh": _qh_pack(q),
                                         "qs": _pack_nibbles(q & 0xF)})


def quantize_row_q5_1(x) -> QTensor:
    b = _blocks(x, 32)
    mn = b.amin(dim=-1)
    d = _div(b.amax(dim=-1) - mn, 31.0)
    iq = torch.floor((b - mn[..., None]) * _safe_inv(d)[..., None] + 0.5)
    q = torch.clamp(iq, 0, 31).to(torch.int32)
    return QTensor(GType.Q5_1, x.shape, {"d": d.to(torch.float16),
                                         "m": mn.to(torch.float16),
                                         "qh": _qh_pack(q),
                                         "qs": _pack_nibbles(q & 0xF)})


def _q5_values(qt):
    return _unpack_nibbles(qt["qs"], 32) | (_qh_unpack(qt["qh"]) << 4)


def dequantize_row_q5_0(qt: QTensor):
    v = _q5_values(qt).to(F32) - 16.0
    return (v * qt["d"].to(F32)[..., None]).reshape(qt.shape)


def dequantize_row_q5_1(qt: QTensor):
    v = _q5_values(qt).to(F32)
    return (v * qt["d"].to(F32)[..., None]
            + qt["m"].to(F32)[..., None]).reshape(qt.shape)


# --- Q8 family (signed int8 lanes) ---------------------------------------

def _q8(b):
    d = _div(b.abs().amax(dim=-1), 127.0)
    q = torch.clamp(_round_half_away(b * _safe_inv(d)[..., None]), -128, 127)
    return q, d


def quantize_row_q8_0(x) -> QTensor:
    q, d = _q8(_blocks(x, 32))
    return QTensor(GType.Q8_0, x.shape, {
        "d": d.to(torch.float16), "qs": q.to(torch.int8).reshape(x.shape)})


def quantize_row_q8_1(x) -> QTensor:
    """Activation side: f32 d and the block-sum correction ``s = d·Σq``."""
    q, d = _q8(_blocks(x, 32))
    return QTensor(GType.Q8_1, x.shape, {
        "d": d, "s": d * q.sum(dim=-1),
        "qs": q.to(torch.int8).reshape(x.shape)})


def quantize_row_q8_k(x) -> QTensor:
    """Activation side of the k-quant dots: f32 d over 256, int16 sums of
    16 quants (llama.cpp block_q8_K)."""
    q, d = _q8(_blocks(x, 256))
    bsums = q.reshape(*q.shape[:-1], 16, 16).sum(dim=-1)
    return QTensor(GType.Q8_K, x.shape, {
        "d": d, "qs": q.to(torch.int8).reshape(x.shape),
        "bsums": bsums.to(torch.int16).flatten(-2)})


def _dequantize_q8(qt, bs):
    qs = qt["qs"].reshape(*qt.shape[:-1], qt.shape[-1] // bs, bs).to(F32)
    return (qs * qt["d"].to(F32)[..., None]).reshape(qt.shape)


def dequantize_row_q8_0(qt: QTensor):
    return _dequantize_q8(qt, 32)


def dequantize_row_q8_1(qt: QTensor):
    return _dequantize_q8(qt, 32)


def dequantize_row_q8_k(qt: QTensor):
    return _dequantize_q8(qt, 256)


# --- k-quant superblocks -------------------------------------------------

def _sum(v):
    """Sum over the last axis from left to right in f32: the JAX package's
    reductions on the CPU add in this order, and the searches below keep an
    argmin/argmax that a last-ulp difference can flip."""
    acc = v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i]
    return acc


def _sqrt_rn(v):
    """f32 square root, correctly rounded on every device. PyTorch's
    vectorised CPU root (AVX-512 builds) is off by one ulp for about one
    value in seven, which the search's argmin can carry into a different
    candidate; the f64 root rounded to f32 is exact (53 >= 2 * 24 + 2
    bits, so the double rounding cannot err), as ggml's sqrtf and XLA's
    are."""
    return torch.sqrt(v.to(torch.float64)).to(F32)


def _qkx2_search(x, nmax: int, rmin=-1.0, rdelta=0.1, nstep=20):
    """make_qkx2_quants-style weighted grid search (llama.cpp's Q4_K
    quality path), per sub-block: nstep + 1 candidate inverse scales, the
    (scale, min) refit by weighted least squares for each candidate's
    levels, the lowest weighted squared error kept. Weights rms(x) + |x|.
    Returns (scale, min <= 0) per sub-block."""
    w = _sqrt_rn(_sum(x * x)[..., None] / x.shape[-1]) + x.abs()
    mn = torch.clamp(x.amin(dim=-1), max=0.0)
    rng = x.amax(dim=-1) - mn
    safe = rng > 0
    srng = torch.where(safe, rng, torch.ones_like(rng))
    zero = torch.zeros_like(rng)

    def levels(iscale):
        lv = torch.round(iscale[..., None] * (x - mn[..., None]))
        return torch.clamp(lv, 0, nmax)

    def werr(scale, m, lv):
        r = x - (scale[..., None] * lv + m[..., None])
        return _sum(w * r * r)

    scale0 = torch.where(safe, _div(rng, nmax), zero)
    best = (scale0, mn,
            werr(scale0, mn,
                 levels(torch.where(safe, _div(nmax, srng), zero))))
    sumw = _sum(w)
    sumx = _sum(w * x)
    for s in range(nstep + 1):
        lv = levels(torch.where(safe, _div(rmin + rdelta * s + nmax, srng),
                                 zero))
        suml = _sum(w * lv)
        suml2 = _sum(w * lv * lv)
        sumxl = _sum(w * x * lv)
        det = sumw * suml2 - suml * suml
        ok = det > 0
        sdet = torch.where(ok, det, torch.ones_like(det))
        D = torch.where(ok, (sumw * sumxl - sumx * suml) / sdet, scale0)
        M = torch.where(ok, (suml2 * sumx - suml * sumxl) / sdet, mn)
        # a positive min is not representable (mins are stored as -min >= 0):
        # clamp it to 0 and refit the scale alone
        pos = M > 0
        has_l = suml2 > 0
        D = torch.where(pos & has_l,
                        sumxl / torch.where(has_l, suml2,
                                            torch.ones_like(suml2)), D)
        M = torch.where(pos, zero, M)
        e = werr(D, M, lv)
        better = ok & (e < best[2])
        best = (torch.where(better, D, best[0]),
                torch.where(better, M, best[1]),
                torch.where(better, e, best[2]))
    return best[0], best[1]


def _qx_search(x, nmax: int, nsteps: int = 9):
    """make_qx_quants-style signed scale search (llama.cpp's Q6_K quality
    path): 2·nsteps + 1 candidate inverse scales -(nmax + 0.1·s)/maxv, the
    scale refit as Σw·x·l / Σw·l² (w = x²), the candidate with the largest
    (Σw·x·l)² / Σw·l² kept. 0 for all-zero sub-blocks."""
    safe = x.abs().amax(dim=-1) > 0
    maxv = _signed_absmax(x)
    den = torch.where(safe, maxv, torch.ones_like(maxv))
    zero = torch.zeros_like(maxv)
    w = x * x
    best_scale = zero
    best_obj = torch.full_like(maxv, float("-inf"))
    for s in range(-nsteps, nsteps + 1):
        isc = torch.where(safe, _div(-(nmax + 0.1 * s), den), zero)
        lv = torch.clamp(torch.round(isc[..., None] * x), -nmax, nmax - 1)
        sumlx = _sum(w * x * lv)
        suml2 = _sum(w * lv * lv)
        ok = suml2 > 0
        sl2 = torch.where(ok, suml2, torch.ones_like(suml2))
        obj = torch.where(ok, sumlx * sumlx / sl2,
                          torch.full_like(sl2, float("-inf")))
        better = ok & (obj > best_obj)
        best_scale = torch.where(better, sumlx / sl2, best_scale)
        best_obj = torch.where(better, obj, best_obj)
    return torch.where(safe, best_scale, zero)


def _pack_kq_scales(sc, m):
    """(..., 8) 6-bit scales and mins -> (..., 12) bytes, ggml's packing
    (the inverse of get_scale_min_k4)."""
    lo = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    mid = (m[..., :4] & 63) | ((m[..., 4:] >> 4) << 6)
    hi = (sc[..., 4:] & 0xF) | ((m[..., 4:] & 0xF) << 4)
    return torch.cat([lo, mid, hi], dim=-1).to(torch.uint8)


def unpack_kq_scales(scales):
    """uint8 (..., 12·n) -> int32 (sc, m), each (..., n, 8): llama.cpp's
    get_scale_min_k4."""
    s = scales.reshape(*scales.shape[:-1], scales.shape[-1] // 12, 12).to(
        torch.int32)
    sc = torch.cat([s[..., 0:4] & 63,
                    (s[..., 8:12] & 0xF) | ((s[..., 0:4] >> 6) << 4)], dim=-1)
    m = torch.cat([s[..., 4:8] & 63,
                   (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)], dim=-1)
    return sc, m


def quantize_row_q4_k(x, search: bool = False) -> QTensor:
    """Q4_K: w = d·sc·q - dmin·m over sub-blocks of 32."""
    b = _blocks(x, 256)
    sb = b.reshape(*b.shape[:-1], 8, 32)
    if search:
        s_best, m_best = _qkx2_search(sb, 15)
        scales = torch.clamp(s_best, min=0.0)
        mins = -m_best
    else:
        mn = torch.clamp(sb.amin(dim=-1), max=0.0)
        scales = _div(sb.amax(dim=-1) - mn, 15.0)
        mins = -mn
    d = _div(scales.amax(dim=-1), 63.0)
    dmin = _div(mins.amax(dim=-1), 63.0)
    sc = torch.clamp(_round_half_away(scales * _safe_inv(d)[..., None]), 0, 63)
    m = torch.clamp(_round_half_away(mins * _safe_inv(dmin)[..., None]), 0, 63)
    eff_d = d[..., None] * sc
    eff_m = dmin[..., None] * m
    iq = torch.floor((sb + eff_m[..., None]) * _safe_inv(eff_d)[..., None]
                     + 0.5)
    q = torch.clamp(iq, 0, 15).to(torch.int32)
    g = q.reshape(*q.shape[:-2], 4, 64)  # byte l of group g: l, 32 + l
    return QTensor(GType.Q4_K, x.shape, {
        "d": d.to(torch.float16), "dmin": dmin.to(torch.float16),
        "scales": _pack_kq_scales(sc.to(torch.int32),
                                  m.to(torch.int32)).flatten(-2),
        "qs": (g[..., :32] | (g[..., 32:] << 4)).to(torch.uint8)
        .flatten(-3)})


def _q4_k_parts(qt):
    """Q4_K -> (q (..., nsb, 8, 32) f32, d, dmin (..., nsb) f32, sc, m
    (..., nsb, 8) f32)."""
    g = qt["qs"].reshape(*qt.shape[:-1], qt.shape[-1] // 256, 4, 32).to(
        torch.int32)
    q = torch.cat([g & 0xF, g >> 4], dim=-1).reshape(*g.shape[:-2], 8, 32)
    sc, m = unpack_kq_scales(qt["scales"])
    return (q.to(F32), qt["d"].to(F32), qt["dmin"].to(F32), sc.to(F32),
            m.to(F32))


def kq_fused_scales(qt: QTensor):
    """The matmul kernels' k-quant scales, f32 values of f16 products:
    Q4_K -> (kd, km), each (..., K/32); Q6_K -> (kd (..., K/16), None)."""
    if qt.gtype == GType.Q4_K:
        _, d, dmin, sc, m = _q4_k_parts(qt)
        kd = (d[..., None] * sc).to(torch.float16).to(F32)
        km = (dmin[..., None] * m).to(torch.float16).to(F32)
        return kd.flatten(-2), km.flatten(-2)
    if qt.gtype == GType.Q6_K:
        sc = qt["sc"].to(F32).reshape(*qt.shape[:-1], qt.shape[-1] // 256, 16)
        kd = qt["d"].to(F32)[..., None] * sc
        return kd.to(torch.float16).to(F32).flatten(-2), None
    raise ValueError(f"{qt.gtype.name} is no k-quant")


def dequantize_row_q4_k(qt: QTensor, fused_scales: bool = False):
    q, d, dmin, sc, m = _q4_k_parts(qt)
    if fused_scales:
        kd, km = kq_fused_scales(qt)
        kd = kd.reshape(sc.shape)
        km = km.reshape(m.shape)
        return (q * kd[..., None] - km[..., None]).reshape(qt.shape)
    w = (d[..., None] * sc)[..., None] * q - (dmin[..., None] * m)[..., None]
    return w.reshape(qt.shape)


def quantize_row_q6_k(x, search: bool = False) -> QTensor:
    """Q6_K: w = d·sc·q over sub-blocks of 16, q signed 6-bit."""
    b = _blocks(x, 256)
    sb = b.reshape(*b.shape[:-1], 16, 16)
    scales = _qx_search(sb, 32) if search else _div(_signed_absmax(sb), -32.0)
    d = _div(_signed_absmax(scales), -127.0)
    sc = torch.clamp(_round_half_away(scales * _safe_inv(d)[..., None]),
                     -128, 127)
    eff = d[..., None] * sc
    iq = torch.clamp(_round_half_away(sb * _safe_inv(eff)[..., None]), -32, 31)
    q = (iq + 32).to(torch.int32).reshape(*b.shape[:-1], 2, 4, 32)
    q1, q2, q3, q4 = q.unbind(dim=-2)  # elements l, l+32, l+64, l+96 a half
    ql = torch.cat([(q1 & 0xF) | ((q3 & 0xF) << 4),
                    (q2 & 0xF) | ((q4 & 0xF) << 4)], dim=-1)
    qh = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    return QTensor(GType.Q6_K, x.shape, {
        "ql": ql.to(torch.uint8).flatten(-3),
        "qh": qh.to(torch.uint8).flatten(-3),
        "sc": sc.to(torch.int8).flatten(-2),
        "d": d.to(torch.float16)})


def _q6_k_values(qt):
    """Q6_K -> q - 32 as f32 (..., nsb, 256) in element order."""
    nsb = qt.shape[-1] // 256
    ql = qt["ql"].reshape(*qt.shape[:-1], nsb, 2, 2, 32).to(torch.int32)
    qh = qt["qh"].reshape(*qt.shape[:-1], nsb, 2, 32).to(torch.int32)
    q1 = (ql[..., 0, :] & 0xF) | ((qh & 3) << 4)
    q2 = (ql[..., 1, :] & 0xF) | (((qh >> 2) & 3) << 4)
    q3 = (ql[..., 0, :] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[..., 1, :] >> 4) | (((qh >> 6) & 3) << 4)
    v = torch.stack([q1, q2, q3, q4], dim=-2)  # (..., nsb, 2, 4, 32)
    return v.reshape(*qh.shape[:-2], 256).to(F32) - 32.0


def dequantize_row_q6_k(qt: QTensor, fused_scales: bool = False):
    q = _q6_k_values(qt).reshape(*qt.shape[:-1], qt.shape[-1] // 256, 16,
                                  16)
    if fused_scales:
        kd, _ = kq_fused_scales(qt)
        return (q * kd.reshape(q.shape[:-1])[..., None]).reshape(qt.shape)
    d = qt["d"].to(F32)[..., None]
    sc = qt["sc"].to(F32).reshape(q.shape[:-1])
    return ((d * sc)[..., None] * q).reshape(qt.shape)


def int_values(qt: QTensor):
    """The integer quants of a 32-element-block tensor before any offset
    (Q4_0/Q4_1 0..15, Q5_0/Q5_1 0..31, Q8_0 -128..127) as int32 [..., K]:
    the weight side of ggml's integer dot."""
    if qt.gtype == GType.Q8_0:
        return qt["qs"].to(torch.int32)
    if qt.gtype in (GType.Q4_0, GType.Q4_1):
        v = _unpack_nibbles(qt["qs"], 32)
    elif qt.gtype in (GType.Q5_0, GType.Q5_1):
        v = _q5_values(qt)
    else:
        raise ValueError(f"{qt.gtype.name} has no integer dot")
    return v.reshape(qt.shape)


_QUANTIZE = {
    GType.Q4_0: quantize_row_q4_0,
    GType.Q4_1: quantize_row_q4_1,
    GType.Q4_2: quantize_row_q4_2,
    GType.Q4_3: quantize_row_q4_3,
    GType.Q5_0: quantize_row_q5_0,
    GType.Q5_1: quantize_row_q5_1,
    GType.Q8_0: quantize_row_q8_0,
    GType.Q8_1: quantize_row_q8_1,
    GType.Q4_K: quantize_row_q4_k,
    GType.Q6_K: quantize_row_q6_k,
    GType.Q8_K: quantize_row_q8_k,
}

_DEQUANTIZE = {
    GType.Q4_0: dequantize_row_q4_0,
    GType.Q4_1: dequantize_row_q4_1,
    GType.Q4_2: dequantize_row_q4_2,
    GType.Q4_3: dequantize_row_q4_3,
    GType.Q5_0: dequantize_row_q5_0,
    GType.Q5_1: dequantize_row_q5_1,
    GType.Q8_0: dequantize_row_q8_0,
    GType.Q8_1: dequantize_row_q8_1,
    GType.Q4_K: dequantize_row_q4_k,
    GType.Q6_K: dequantize_row_q6_k,
    GType.Q8_K: dequantize_row_q8_k,
}


def quantize(x, gtype, search: bool = False) -> QTensor:
    """x [..., K] float -> QTensor of ``gtype`` (blocks along the last axis).
    search=True runs the k-quants' quality search (slower; ignored by the
    other formats)."""
    gtype = GType(gtype)
    _check_format(gtype)
    if search and gtype in (GType.Q4_K, GType.Q6_K):
        return _QUANTIZE[gtype](x, search=True)
    return _QUANTIZE[gtype](x)


def dequantize(qt: QTensor, fused_scales: bool = False):
    """QTensor -> float32 tensor of its logical shape. fused_scales: the
    k-quants' matmul-kernel weights (module docstring)."""
    _check_format(qt.gtype)
    if fused_scales and qt.gtype in (GType.Q4_K, GType.Q6_K):
        return _DEQUANTIZE[qt.gtype](qt, fused_scales=True)
    return _DEQUANTIZE[qt.gtype](qt)
