"""The Q4_0 dequant-matmul's nibble-to-number step in three builds, and the
card's copy ceiling (counterpart of scripts/probe_dq_variants.py: its
``mm`` at :81, three TPU inner loops, and ``dma_copy`` at :105).

  * ``csrc/matmul_q4_0.cu`` built with ``-DQ4_UNPACK=`` 0 (prmt, the
    default: the byte permute into 2^23's mantissa, TPU variant b), 1 (i2f:
    an integer-to-float conversion, TPU variant c) and 2 (half2: 16-bit
    operands, products summed in packed f16 and widened once a block, TPU
    variant a). i2f must equal prmt bit for bit (both give q - 8 exactly,
    the TPU script's "max|b - c| = 0"); half2 is held to its derived bar.
    Each is timed at N = K = 4096 (the site's shape) and at the 7B shapes,
    b = 1, against the plain version (``ops.mul_mat_q``) and a bf16
    ``torch.matmul`` over the dequantized weight.
  * ``csrc/probes.cu::probe_copy``: a 16-byte grid-stride copy of the
    site's 8 MB plane (rotated past the L2) and of a 1 GiB plane, which no
    cache holds: read + write bytes over time is the card's copy ceiling.
    Plain version ``src.clone()``, library call ``dst.copy_(src)``.

Run on the card:  python -m ggmlsharp_tpu_torch.probes.dq_variants
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from ..dtypes import GType
from ..kernels import _build
from ..kernels.config import use_kernel
from ..kernels.matmul_q import _launch, geometry
from ..ops.matmul import mul_mat_q
from ..quant.formats import QTensor
from ..quant.quantize import dequantize
from .common import (bound_ms, card, cold_copies, emit, parse_device,
                     q4_bytes, time_ms)

VARIANTS = {"prmt": 0, "i2f": 1, "half2": 2}
HALF2_T = 4  # products a half of a __half2 sums in f16 before widening
SITE_SHAPE = (4096, 4096)
SHAPES = [(4096, 4096), (12288, 4096), (22016, 4096), (4096, 11008),
          (32256, 4096), (32000, 4096)]
COPY_SITE = (4096, 512)   # the site's qs plane, u32: 8 MB
COPY_BIG_BYTES = 1 << 30  # no cache holds it


def variant_defines(variant: str) -> tuple:
    v = VARIANTS[variant]
    return () if v == 0 else (f"Q4_UNPACK={v}",)


def build_variants():
    """Build the three libraries of matmul_q4_0.cu, all at once."""
    return _build.build([], variants=[("matmul_q4_0", variant_defines(v))
                                      for v in VARIANTS])


@contextlib.contextmanager
def variant(name: str):
    """matmul_q4_0 built with the Q4_UNPACK of ``name`` while inside."""
    prev = _build._DEFINES.get("matmul_q4_0", ())
    _build.set_defines("matmul_q4_0", variant_defines(name))
    try:
        yield
    finally:
        _build.set_defines("matmul_q4_0", prev)


def q4_0_variant(x, w: QTensor, name: str, geom=None):
    """matmul_q4_0 in the build ``name`` (call inside ``variant(name)``);
    launches count as ``matmul_q4_0`` for prmt, ``matmul_q4_0_<name>``
    otherwise."""
    counter = "matmul_q4_0" if name == "prmt" else f"matmul_q4_0_{name}"
    return _launch("matmul_q4_0", x, w["qs"], w["d"], torch.uint8,
                   x.shape[1] // 2, GType.Q4_0, geom, counter=counter)


def abs_sums(x, w: QTensor):
    """sum_k |x_k| |w_nk| for every output: the scale of every bar."""
    return x.abs() @ dequantize(w).abs().T


def half2_bar(sums):
    """half2's bound: x rounded to f16 and HALF2_T products summed in f16,
    each a rounding of at most 2^-11 of the running magnitude, so
    (HALF2_T + 1) * 2^-11 of sum |x w|; plus the f32 bar of the exact
    kernels (1e-5 of the sum) for the f32 accumulation across blocks."""
    return ((HALF2_T + 1) * 2.0 ** -11 + 1e-5) * sums


def check(dev, gen, n=4096, k=4096):
    """Each build against the plain version at [n, k], b = 1 (the only
    instance Q4_UNPACK changes; more rows take the multi-row instance):
    prmt within 1e-5 of sum |x w| (summation order), i2f equal to prmt bit
    for bit, half2 within half2_bar. Raises on a disagreement."""
    from ..models.llama import random_q4_0

    w = random_q4_0(n, k, gen, dev)
    b = 1
    x = torch.randn((b, k), generator=gen, device=dev)
    want = mul_mat_q(w, x, quantize_acts=False)
    sums = abs_sums(x, w)
    got = {}
    for name in VARIANTS:
        with variant(name):
            got[name] = q4_0_variant(x, w, name)
    torch.cuda.synchronize()
    err = {v: (y - want).abs() for v, y in got.items()}
    row = {"b": b, "n": n, "k": k,
           "max_abs_err": {v: float(e.max()) for v, e in err.items()},
           "i2f_equals_prmt": bool(torch.equal(got["i2f"],
                                               got["prmt"])),
           "prmt_ok": bool((err["prmt"] <= 1e-5 * sums).all()),
           "half2_terms_t": HALF2_T,
           "half2_bar_max": float(half2_bar(sums).max()),
           "half2_err_over_bar": float((err["half2"]
                                        / half2_bar(sums)).max()),
           "finite": all(bool(torch.isfinite(y).all())
                         for y in got.values())}
    row["half2_ok"] = row["half2_err_over_bar"] <= 1.0
    emit({"dq_variants_check": row})
    if not (row["finite"] and row["prmt_ok"] and row["i2f_equals_prmt"]
            and row["half2_ok"]):
        raise RuntimeError(f"Q4_UNPACK variants disagree: {row}")
    return [row]


def time_variants(dev, gen, shapes=SHAPES, reps=40):
    """Each build's ms at each shape, b = 1, cold L2, the geometry the
    tune table gives the shape; the plain version and a bf16 library
    matmul over the dequantized weight beside them."""
    from ..models.llama import random_q4_0

    rows = []
    for n, k in shapes:
        copies = cold_copies(n * k * 18 // 32)
        ws = [random_q4_0(n, k, gen, dev) for _ in range(copies)]
        x = torch.randn((1, k), generator=gen, device=dev)
        row = {"n": n, "k": k, "b": 1, "geometry": list(geometry(
            "matmul_q4_0", n, k, GType.Q4_0))}
        wbytes = n * k * 18 // 32
        for name in VARIANTS:
            with variant(name):
                ms = time_ms(lambda i: q4_0_variant(x, ws[i % copies], name),
                             reps)
            row[f"{name}_ms"] = ms
            row[f"{name}_weight_gb_s"] = wbytes / ms / 1e6
        row["plain_ms"] = time_ms(lambda i: mul_mat_q(
            ws[i % copies], x, quantize_acts=False), 5)
        wb = [dequantize(w).to(torch.bfloat16) for w in ws[:2]]
        xb = x.to(torch.bfloat16)
        row["library_ms"] = time_ms(lambda i: torch.matmul(xb, wb[i % 2].T),
                                    reps)
        row["bound_ms"], row["bound_by"] = bound_ms(q4_bytes(1, n, k),
                                                    2.0 * n * k)
        rows.append(row)
        emit({"dq_variants_timing": row})
        del ws, wb
        torch.cuda.empty_cache()
    return rows


def copy_plane(src, out=None, plain: bool = False):
    """A copy of ``src`` (contiguous, 16-byte aligned, a multiple of 16
    bytes): the probes.cu copy kernel for a CUDA tensor, ``src.clone()``
    for a CPU one or with plain=True."""
    if not use_kernel(src, plain):
        return src.clone()
    nbytes = src.numel() * src.element_size()
    if not src.is_contiguous() or src.data_ptr() % 16 or nbytes % 16:
        raise ValueError("copy_plane: src must be contiguous, 16-byte "
                         "aligned and a multiple of 16 bytes")
    dst = torch.empty_like(src) if out is None else out
    if dst.shape != src.shape or dst.dtype != src.dtype \
            or dst.device != src.device or not dst.is_contiguous() \
            or dst.data_ptr() % 16:
        raise ValueError("copy_plane: out does not match src")
    fn = _build.entry("probe_copy")
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), dst.data_ptr(), nbytes // 16,
                torch.cuda.current_stream().cuda_stream)
    _build.check("probe_copy", rc)
    return dst


def copy_probe(dev, gen):
    """The copy kernel on the site's 8 MB plane (copies rotated past the
    L2) and on a 1 GiB plane: (read + write) bytes over time, beside the
    plain version and ``dst.copy_(src)``. Each copy is checked."""
    rows = []
    n_site = COPY_SITE[0] * COPY_SITE[1]
    for label, numel, reps in (("site_8MB", n_site, 50),
                               ("1GiB", COPY_BIG_BYTES // 4, 8)):
        nbytes = numel * 4
        copies = cold_copies(nbytes) if label == "site_8MB" else 1
        srcs = [torch.randint(-2**31, 2**31 - 1, (numel,), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(copies)]
        dsts = [torch.empty_like(s) for s in srcs]
        for s, d in zip(srcs, dsts):
            copy_plane(s, out=d)
        torch.cuda.synchronize()
        if not all(torch.equal(s, d) for s, d in zip(srcs, dsts)):
            raise RuntimeError(f"copy kernel: a copy differs ({label})")
        ms = time_ms(lambda i: copy_plane(srcs[i % copies],
                                          out=dsts[i % copies]), reps)
        lib = time_ms(lambda i: dsts[i % copies].copy_(srcs[i % copies]),
                      reps)
        plain = time_ms(lambda i: srcs[i % copies].clone(), reps)
        b, by = bound_ms(2 * nbytes)
        row = {"plane": label, "bytes": nbytes, "ms": ms,
               "gb_s": 2 * nbytes / ms / 1e6, "library_ms": lib,
               "library_gb_s": 2 * nbytes / lib / 1e6, "plain_ms": plain,
               "bound_ms": b, "bound_by": by, "max_abs_err": 0.0}
        rows.append(row)
        emit({"copy_probe": row})
        del srcs, dsts
        torch.cuda.empty_cache()
    return rows


def plain_check(dev):
    """The CPU run: the plain Q4_0 version against the TPU script's own
    arithmetic, x @ ((q - 8) d), and the plain copy; no time is taken."""
    from ..models.llama import random_q4_0
    from ..quant.quantize import int_values

    gen = torch.Generator(dev).manual_seed(0)
    w = random_q4_0(256, 512, gen, dev)
    x = torch.randn((2, 512), generator=gen, device=dev)
    q = int_values(w).to(torch.float32) - 8.0
    ref = x @ (q * w["d"].to(torch.float32).repeat_interleave(32, 1)).T
    err = float((mul_mat_q(w, x, quantize_acts=False) - ref).abs().max())
    src = torch.arange(1024, dtype=torch.int32, device=dev)
    same = bool(torch.equal(copy_plane(src), src))
    emit({"dq_variants_plain": {"device": str(dev), "max_abs_err": err,
                                "copy_equal": same, "times": "not measured"}})
    return err, same


def run(dev):
    """Build, check and time everything on the card; the results."""
    t0 = time.perf_counter()
    logs = build_variants()
    _build.build(["probe_copy"])
    gen = torch.Generator(dev).manual_seed(0)
    res = {"card": card(), "build_s": time.perf_counter() - t0,
           "built": sorted(logs)}
    res["check"] = check(dev, gen)
    res["timing"] = time_variants(dev, gen)
    res["copy"] = copy_probe(dev, gen)
    return res


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type == "cpu":
        plain_check(dev)
        return 0
    res = run(dev)
    emit({"dq_variants": {"card": res["card"], "build_s": res["build_s"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
