"""The kernels' scale load over every f16 pattern, their element-to-scale
maps, and the bad-entry map of a Q4_0 matmul (counterpart of
scripts/diag_chunked10.py: its decode kernel at :42, its repeat kernel at
:68 and its part 2, :81-127).

  * ``csrc/probes.cu::probe_f16_decode``: all 65,536 f16 patterns through
    the scale load of the port's kernels (``__half2float`` of an ``__ldg``
    of the d plane); held bit for bit against ``u16.view(float16).float()``
    on the finite patterns, +0 and -0 equal (the TPU script's rule).
  * ``csrc/probes.cu::probe_block_map``: for each element k of a row, the
    scale each kernel's lane map assigns (Q4_0, Q8_0, the legacy formats of
    32 and of 16 elements a block, Q4_K's and Q6_K's sub-blocks), one
    distinct value a block; held exactly against ``np.repeat`` (a block
    repeat: the TPU's ``pltpu.repeat`` tiles instead, which is why its
    kernels interleaved their blocks).
  * The bad-entry map: ``matmul_q4_0`` at N 256, K 1024, B 8 (seed 7,
    weights N(0, 0.25)) against x @ dequantize(w)ᵀ; an entry is bad where
    |got - want| / (|want| + 0.2) > 0.1. Expect none.

Run on the card:  python -m ggmlsharp_tpu_torch.probes.scale_decode
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..dtypes import GType
from ..kernels import _build
from ..kernels.config import use_kernel
from ..kernels.matmul_q import mul_mat_q_fused
from ..quant.quantize import dequantize, quantize
from .common import bound_ms, card, emit, parse_device, time_ms

# format -> elements a scale covers in the kernels' maps
MAP_BLOCK = {GType.Q4_0: 32, GType.Q8_0: 32, GType.Q4_1: 32, GType.Q5_0: 32,
             GType.Q5_1: 32, GType.Q4_2: 16, GType.Q4_3: 16, GType.Q4_K: 32,
             GType.Q6_K: 16}
MAP_K = 11008  # 7B w_down's K: 43 superblocks, 344 blocks


def all_f16():
    """Every f16 bit pattern, 0..65535 in order."""
    return torch.from_numpy(np.arange(65536, dtype=np.uint16).view(
        np.float16).copy())


def f16_decode_ref(d):
    return d.to(torch.float32)


def f16_decode(d, plain: bool = False):
    """f16 [n] -> f32 [n] through the kernels' scale load (the kernel for a
    CUDA tensor), or f16_decode_ref."""
    if not use_kernel(d, plain):
        return f16_decode_ref(d)
    if d.dtype != torch.float16 or d.dim() != 1 or not d.is_contiguous():
        raise ValueError("f16_decode: d must be a contiguous f16 [n]")
    out = torch.empty(d.numel(), dtype=torch.float32, device=d.device)
    fn = _build.entry("probe_f16_decode")
    with torch.cuda.device(d.device):
        rc = fn(d.data_ptr(), out.data_ptr(), d.numel(),
                torch.cuda.current_stream().cuda_stream)
    _build.check("probe_f16_decode", rc)
    return out


def decode_mismatches(got, want) -> tuple[int, int]:
    """(patterns that differ, finite patterns): bit for bit on the finite
    patterns, +0 and -0 taken as equal."""
    got, want = got.cpu(), want.cpu()
    finite = torch.isfinite(want)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        (got == 0) & (want == 0))
    return int((~same & finite).sum()), int(finite.sum())


def block_map_ref(fmt, d):
    """The scale of each element: d repeated block by block."""
    return torch.repeat_interleave(d, MAP_BLOCK[GType(fmt)])


def block_map(fmt, d, k: int, plain: bool = False):
    """f32 [k]: the scale each element of a row receives from ``d`` (one
    value a block of MAP_BLOCK[fmt]) under format ``fmt``'s kernel lane
    map (the kernel for a CUDA tensor), or block_map_ref."""
    if not use_kernel(d, plain):
        return block_map_ref(fmt, d)
    if d.dtype != torch.float32 or d.numel() * MAP_BLOCK[GType(fmt)] != k \
            or not d.is_contiguous():
        raise ValueError(f"block_map: d {tuple(d.shape)} for K {k}")
    out = torch.full((k,), float("nan"), dtype=torch.float32,
                     device=d.device)
    fn = _build.entry("probe_block_map")
    with torch.cuda.device(d.device):
        rc = fn(int(fmt), d.data_ptr(), out.data_ptr(), k,
                torch.cuda.current_stream().cuda_stream)
    _build.check("probe_block_map", rc)
    return out


def check_decode(dev):
    d = all_f16().to(dev)
    bad, finite = decode_mismatches(f16_decode(d), f16_decode_ref(d))
    row = {"patterns": 65536, "finite": finite, "wrong": bad}
    emit({"f16_decode_check": row})
    if bad:
        raise RuntimeError(f"f16 scale decode differs: {row}")
    return row


def check_block_maps(dev, k: int = MAP_K):
    rows = {}
    for fmt, bs in MAP_BLOCK.items():
        d = torch.arange(1, k // bs + 1, dtype=torch.float32, device=dev)
        got = block_map(fmt, d, k)
        ok = bool(torch.equal(got, block_map_ref(fmt, d)))
        rows[fmt.name] = ok
        if not ok:
            emit({"block_map_check": rows})
            raise RuntimeError(f"{fmt.name}: the kernels' block map is not a "
                               f"block repeat")
    emit({"block_map_check": {"k": k, "equal_repeat": rows}})
    return rows


def bad_entry_map(dev, plain: bool = False):
    """diag_chunked10.py's part 2 through matmul_q4_0 (or its plain version):
    the bad entries of x @ wᵀ at N 256, K 1024, B 8, in mm_dot "f32" (the
    entries the TPU diagnosis hunted were the bf16 rounding of its default
    mode; the exact function must have none)."""
    rng = np.random.default_rng(7)
    n, k, b = 256, 1024, 8
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                         * 0.5).to(dev)
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32)
                         ).to(dev)
    qw = quantize(w, GType.Q4_0)
    want = x @ dequantize(qw).T
    got = mul_mat_q_fused(qw, x, quantize_acts=False, plain=plain,
                          mode="f32")
    err = (got - want).abs() / (want.abs() + 2e-1)
    bad = err > 0.1
    cols = torch.nonzero(bad.any(dim=0)).flatten().tolist()
    row = {"n": n, "k": k, "b": b, "bad_entries": int(bad.sum()),
           "entries": bad.numel(), "bad_cols": cols[:24],
           "max_rel_err": float(err.max()),
           "max_abs_err": float((got - want).abs().max())}
    emit({"bad_entry_map": row})
    if row["bad_entries"]:
        raise RuntimeError(f"Q4_0 matmul has bad entries: {row}")
    return row


def time_probes(dev):
    """The two kernels' ms beside their plain versions (each a single
    PyTorch call, so also the library time) and bounds."""
    d = all_f16().to(dev)
    dec = {"ms": time_ms(lambda i: f16_decode(d), 50),
           "plain_ms": time_ms(lambda i: f16_decode_ref(d), 50)}
    dec["library_ms"] = dec["plain_ms"]
    dec["bound_ms"], dec["bound_by"] = bound_ms(65536 * (2 + 4))
    dm = torch.arange(1, MAP_K // 32 + 1, dtype=torch.float32, device=dev)
    bm = {"ms": time_ms(lambda i: block_map(GType.Q4_0, dm, MAP_K), 50),
          "plain_ms": time_ms(lambda i: block_map_ref(GType.Q4_0, dm), 50)}
    bm["library_ms"] = bm["plain_ms"]
    bm["bound_ms"], bm["bound_by"] = bound_ms(dm.numel() * 4 + MAP_K * 4)
    return dec, bm


def run(dev):
    t0 = time.perf_counter()
    _build.build(["probe_f16_decode", "matmul_q4_0"])
    res = {"card": card(), "build_s": time.perf_counter() - t0}
    res["decode"] = check_decode(dev)
    res["block_map"] = check_block_maps(dev)
    res["bad_entry_map"] = bad_entry_map(dev)
    res["decode_timing"], res["block_map_timing"] = time_probes(dev)
    return res


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type == "cpu":
        check_decode(dev)
        check_block_maps(dev)
        bad_entry_map(dev)
        emit({"scale_decode_plain": {"device": "cpu",
                                     "times": "not measured"}})
        return 0
    res = run(dev)
    emit({"scale_decode": {"card": res["card"], "build_s": res["build_s"],
                           "decode_timing": res["decode_timing"],
                           "block_map_timing": res["block_map_timing"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
