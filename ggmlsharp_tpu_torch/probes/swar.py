"""The byte order of the Q4 kernels' loads, and a K-major Q4_0 layout against
the row layout (counterpart of scripts/probe_swar.py: its
``probe_bitcast_order`` at :61 and ``swar_mm`` at :105).

  * ``csrc/probes.cu::probe_byte_order`` loads known words as the port's Q4
    kernels do (a u32 ``__ldg`` at byte offset c*16 + j, then
    ``__byte_perm`` selector 0x7440 + t) and writes which source byte lands
    in each output position; the plain version is a view of the same bytes.
    Little-endian gives 4r + b (what the TPU script prints on the CPU).
  * ``csrc/matmul_q4_0_kmajor.cu``: y = x·((q - 8)·d)ᵀ over P u32 [K/8, N]
    (word (r, n) holds nibbles k = 8r..8r+7 of row n, in order) and d f16
    [K/32, N]: neighbouring threads on neighbouring rows, 16-byte loads, K
    split over blocks. Its plain version inverts the repack and runs
    ``ops.mul_mat_q``. Checked at the site's N 512, K 1024, b 8 and at the
    timed shapes; timed at the site's four shapes (32256 is the TPU's padded
    LM head) and the port's 32000, b = 1, against ``matmul_q4_0`` over the
    same weights in the row layout, at the default and the tuned geometry.

The TPU script's block-interleaved sublane order (``pack_plane``, ``perms``)
exists for ``pltpu.repeat``'s tile semantics and has no counterpart: the
K-major words hold their nibbles in element order.

Run on the card:  python -m ggmlsharp_tpu_torch.probes.swar
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..dtypes import GType
from ..kernels import _build, tune
from ..kernels.config import use_kernel
from ..kernels.matmul_q import geometry, q4_0_matmul
from ..ops.matmul import mul_mat_q
from ..quant.formats import QTensor
from ..quant.quantize import _pack_nibbles, _to_int32, _unpack_nibbles
from .common import (bound_ms, card, cold_copies, emit, parse_device,
                     q4_bytes, time_ms)

CHECK_SHAPE = (512, 1024, 8)  # the site's check_correct: N, K, b
SHAPES = [(4096, 4096), (12288, 4096), (22016, 4096), (32256, 4096),
          (32000, 4096)]
BYTE_WORDS = 64  # 256 source bytes, each its own value
THREADS, ROWS_PER_THREAD = 128, 4  # matmul_q4_0_kmajor.cu's block


# ---- byte order (site 14) ----------------------------------------------

def byte_order_ref(src):
    """The source byte's value at each output position 4r + b: byte b of
    word r as the bytes lie in memory (little-endian), as numpy views
    them."""
    return torch.from_numpy(np.frombuffer(src.cpu().numpy().tobytes(),
                                          np.uint8).astype(np.int32))


def byte_order(src, plain: bool = False):
    """(map int32 [4W], val f32 [4W]) of uint8 src [4W]: the source byte
    each output position receives under the Q4 kernels' loads and byte
    permutes, and that byte's value through 2^23's mantissa."""
    if not use_kernel(src, plain):
        m = byte_order_ref(src).to(src.device)
        return m, m.to(torch.float32)
    if src.dtype != torch.uint8 or src.dim() != 1 or src.numel() % 4 \
            or not src.is_contiguous() or src.data_ptr() % 4:
        raise ValueError("byte_order: src must be contiguous, aligned uint8 "
                         "[4 * words]")
    nw = src.numel() // 4
    m = torch.empty(4 * nw, dtype=torch.int32, device=src.device)
    v = torch.empty(4 * nw, dtype=torch.float32, device=src.device)
    fn = _build.entry("probe_byte_order")
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), nw, m.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check("probe_byte_order", rc)
    return m, v


def byte_order_label(m) -> str:
    """"4r+b" when output 4r + b holds byte b of word r (the TPU script's
    names), else "unknown"."""
    m = np.asarray(m)
    return "4r+b" if (m == np.arange(m.size)).all() else "unknown"


def check_byte_order(dev):
    src = torch.arange(4 * BYTE_WORDS, dtype=torch.int32,
                       device=dev).to(torch.uint8)
    m, v = byte_order(src)
    want = byte_order_ref(src).to(dev)
    torch.cuda.synchronize()
    ok = bool(torch.equal(m, want)) and bool(torch.equal(
        v, want.to(torch.float32)))
    row = {"words": BYTE_WORDS, "order": byte_order_label(m.cpu()),
           "equal_plain": ok, "max_abs_err": float((v - want).abs().max())}
    emit({"byte_order_check": row})
    if not ok or row["order"] != "4r+b":
        raise RuntimeError(f"byte order differs from the plain map: {row}")
    return row


# ---- the K-major layout (site 15) --------------------------------------

def kmajor_repack(w: QTensor):
    """A Q4_0 [N, K] in the row layout -> (P int32 [K/8, N], the bits of
    u32 words holding nibbles k = 8r..8r+7 of row n in order; d f16
    [K/32, N])."""
    if w.gtype != GType.Q4_0:
        raise ValueError("kmajor_repack: Q4_0 only")
    n, k = w.shape
    q = _unpack_nibbles(w["qs"], 32).reshape(n, k).to(torch.int64)
    qt = q.T.reshape(k // 8, 8, n)
    shifts = (4 * torch.arange(8, device=q.device)).reshape(1, 8, 1)
    P = _to_int32((qt << shifts).sum(dim=1))
    return P.contiguous(), w["d"].T.contiguous()


def kmajor_unpack(P, d) -> QTensor:
    """Inverse of kmajor_repack."""
    k8, n = P.shape
    k = 8 * k8
    v = P.to(torch.int64) & 0xFFFFFFFF
    shifts = (4 * torch.arange(8, device=P.device)).reshape(1, 8, 1)
    q = ((v[:, None, :] >> shifts) & 0xF).reshape(k, n).T
    qs = _pack_nibbles(q.reshape(n, k // 32, 32))
    return QTensor(GType.Q4_0, (n, k), {"qs": qs.contiguous(),
                                        "d": d.T.contiguous()})


def kmajor_matmul_ref(x, P, d):
    """The plain version: the repack inverted, then ops.mul_mat_q (f32)."""
    return mul_mat_q(kmajor_unpack(P, d), x, quantize_acts=False)


def kmajor_splits(n: int, k: int) -> int:
    """32-element blocks a split of K: enough blocks to give the 132 SMs
    two each, at most 32 (the x slice in shared memory)."""
    nbx = -(-n // (THREADS * ROWS_PER_THREAD))
    want = -(-2 * 132 // nbx)
    return max(1, min(32, -(-(k // 32) // want)))


def kmajor_matmul(x, P, d, plain: bool = False, cps: int | None = None):
    """x f32 [B, K] -> y f32 [B, N] over the K-major layout: the kernel for a
    CUDA tensor, kmajor_matmul_ref for a CPU one or with plain=True."""
    if not use_kernel(x, plain):
        return kmajor_matmul_ref(x, P, d)
    B, K = x.shape
    N = P.shape[1]
    if K % 32 or N % 4 or tuple(P.shape) != (K // 8, N) \
            or tuple(d.shape) != (K // 32, N) or P.dtype != torch.int32 \
            or d.dtype != torch.float16 or x.dtype != torch.float32:
        raise ValueError(f"kmajor_matmul: x {tuple(x.shape)} {x.dtype}, P "
                         f"{tuple(P.shape)} {P.dtype}, d {tuple(d.shape)} "
                         f"{d.dtype}")
    if not (x.is_contiguous() and P.is_contiguous() and d.is_contiguous()) \
            or P.data_ptr() % 16 or d.data_ptr() % 8 or x.data_ptr() % 4 \
            or P.device != x.device or d.device != x.device:
        raise ValueError("kmajor_matmul: inputs must be contiguous, aligned "
                         "and on one card")
    cps = kmajor_splits(N, K) if cps is None else cps
    splits = -(-(K // 32) // cps)
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    part = y if splits == 1 else torch.empty(
        (splits, B, N), dtype=torch.float32, device=x.device)
    fn = _build.entry("matmul_q4_0_kmajor")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), P.data_ptr(), d.data_ptr(), part.data_ptr(),
                y.data_ptr(), B, N, K, cps,
                torch.cuda.current_stream().cuda_stream)
    _build.check("matmul_q4_0_kmajor", rc)
    return y


def check_kmajor(dev, gen, shapes=None):
    """The kernel against its plain version: at the site's check shape and,
    on the card, at each timed shape with b = 1; within 1e-5 of
    sum |x|·|q·d| (f32 summation order, kernel 1's bar)."""
    from ..models.llama import random_q4_0
    from ..quant.quantize import dequantize

    n0, k0, b0 = CHECK_SHAPE
    cases = [(n0, k0, b0)] + [(n, k, 1) for n, k in (shapes or [])]
    rows = []
    for n, k, b in cases:
        w = random_q4_0(n, k, gen, dev)
        P, d = kmajor_repack(w)
        x = torch.randn((b, k), generator=gen, device=dev)
        got = kmajor_matmul(x, P, d)
        want = kmajor_matmul_ref(x, P, d)
        sums = x.abs() @ dequantize(w).abs().T
        err = (got - want).abs()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        row = {"n": n, "k": k, "b": b, "max_abs_err": float(err.max()),
               "max_err_over_sum": float((err / sums).max()),
               "ok": bool(torch.isfinite(got).all())
               and bool((err <= 1e-5 * sums).all())}
        rows.append(row)
        emit({"kmajor_check": row})
        if not row["ok"]:
            raise RuntimeError(f"K-major kernel disagrees: {row}")
    return rows


def time_kmajor(dev, gen, shapes=SHAPES, reps=40):
    """ms at each shape, b = 1, cold L2: the K-major kernel, matmul_q4_0
    over the same weights in the row layout at the default and the tuned
    geometry, the plain version and a bf16 library matmul."""
    from ..models.llama import random_q4_0
    from ..quant.quantize import dequantize

    rows = []
    for n, k in shapes:
        copies = cold_copies(n * k * 18 // 32)
        ws = [random_q4_0(n, k, gen, dev) for _ in range(copies)]
        km = [kmajor_repack(w) for w in ws]
        x = torch.randn((1, k), generator=gen, device=dev)
        tuned = geometry("matmul_q4_0", n, k, GType.Q4_0)
        row = {"n": n, "k": k, "b": 1, "splits_blocks": kmajor_splits(n, k),
               "tuned_geometry": list(tuned)}
        row["kmajor_ms"] = time_ms(lambda i: kmajor_matmul(
            x, *km[i % copies]), reps)
        row["row_default_ms"] = time_ms(lambda i: q4_0_matmul(
            x, ws[i % copies]["qs"], ws[i % copies]["d"], tune.DEFAULT),
            reps)
        row["row_tuned_ms"] = time_ms(lambda i: q4_0_matmul(
            x, ws[i % copies]["qs"], ws[i % copies]["d"], tuned), reps)
        row["plain_ms"] = time_ms(lambda i: kmajor_matmul_ref(
            x, *km[i % copies]), 3)
        wb = [dequantize(w).to(torch.bfloat16) for w in ws[:2]]
        xb = x.to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda i: torch.matmul(xb, wb[i % 2].T),
                                    reps)
        row["bound_ms"], row["bound_by"] = bound_ms(q4_bytes(1, n, k),
                                                    2.0 * n * k)
        wbytes = n * k * 18 // 32
        for key in ("kmajor", "row_default", "row_tuned"):
            row[f"{key}_weight_gb_s"] = wbytes / row[f"{key}_ms"] / 1e6
        rows.append(row)
        emit({"kmajor_timing": row})
        del ws, km, wb
        torch.cuda.empty_cache()
    return rows


def time_byte_order(dev):
    src = torch.arange(4 * BYTE_WORDS, dtype=torch.int32,
                       device=dev).to(torch.uint8)
    ms = time_ms(lambda i: byte_order(src), 50)
    plain = time_ms(lambda i: src.to(torch.int32), 50)
    b, by = bound_ms(src.numel() * (1 + 4 + 4))
    return {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b,
            "bound_by": by}


def run(dev):
    t0 = time.perf_counter()
    _build.build(["probe_byte_order", "matmul_q4_0_kmajor", "matmul_q4_0"])
    gen = torch.Generator(dev).manual_seed(0)
    res = {"card": card(), "build_s": time.perf_counter() - t0}
    res["byte_order"] = check_byte_order(dev)
    res["byte_order"].update(time_byte_order(dev))
    res["check"] = check_kmajor(dev, gen, SHAPES)
    res["timing"] = time_kmajor(dev, gen)
    return res


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type == "cpu":
        gen = torch.Generator(dev).manual_seed(0)
        src = torch.arange(4 * BYTE_WORDS, dtype=torch.int32).to(torch.uint8)
        emit({"swar_plain": {"device": "cpu",
                             "order": byte_order_label(byte_order(src)[0]),
                             "kmajor": check_kmajor(dev, gen),
                             "times": "not measured"}})
        return 0
    res = run(dev)
    emit({"swar": {"card": res["card"], "build_s": res["build_s"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
