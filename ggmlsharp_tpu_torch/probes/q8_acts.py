"""Q8_0 weights against Q8_0 activations at two and more rows: the int8
tensor cores (``dq_mma.cuh::q8_i8_kernel``, the default) against the shared
multi-row kernel's one-plane route (the int8 values as one bf16 plane
against ``DecQ8``'s exact bf16 weights, read in the kernel, the K splits
reduced in a cluster: one launch, as the int8 kernel), two builds of
``csrc/matmul_q8_0.cu`` (``-DQ8_ACTS=`` 0 and 1).

Each build is held against the plain version (``ops.mul_mat_q`` on the
Q8_0 round trip of x) within 1e-5 of sum |x||w| and timed, cold L2, in
turns (i8, bf16, i8, bf16) at GPT-2 124M's and 774M's c_attn and c_proj, b
2 and 16, and at path f's Llama-7B w_gate_up and w_down, b 16; a bf16
``torch.matmul`` over the dequantized weight beside them.

Run on the card:  python -m ggmlsharp_tpu_torch.probes.q8_acts
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from ..dtypes import GType
from ..kernels import _build
from ..kernels.matmul_q import mma_q8_matmul
from ..ops import quantize_activations
from ..ops.matmul import mul_mat_q
from ..quant.quantize import dequantize
from .common import card, cold_copies, emit, parse_device, time_ms

VARIANTS = {"i8": 0, "bf16": 1}
ENTRY = "matmul_q8_0_mma"
# (name, N, K, rows)
SHAPES = [("124M_c_attn", 2304, 768, (2, 16)),
          ("124M_c_proj", 768, 768, (2, 16)),
          ("774M_c_attn", 3840, 1280, (2, 16)),
          ("774M_c_proj", 1280, 1280, (2, 16)),
          ("7B_w_gate_up", 22016, 4096, (16,)),
          ("7B_w_down", 4096, 11008, (16,))]


def variant_defines(variant: str) -> tuple:
    v = VARIANTS[variant]
    return () if v == 0 else (f"Q8_ACTS={v}",)


def build_variants():
    """Build both libraries of matmul_q8_0.cu, at once."""
    return _build.build([], variants=[(ENTRY, variant_defines(v))
                                      for v in VARIANTS])


@contextlib.contextmanager
def variant(name: str):
    """matmul_q8_0_mma built with the Q8_ACTS of ``name`` while inside."""
    prev = _build._DEFINES.get(ENTRY, ())
    _build.set_defines(ENTRY, variant_defines(name))
    try:
        yield
    finally:
        _build.set_defines(ENTRY, prev)


def inputs(n, k, b, gen, dev, copies=1):
    """``copies`` random Q8_0 weights [n, k] and x [b, k] with its Q8_0
    activations."""
    from ..models.gpt2 import random_q8_0

    ws = [random_q8_0(n, k, gen, dev) for _ in range(copies)]
    x = torch.randn((b, k), generator=gen, device=dev)
    return ws, x, quantize_activations(x, GType.Q8_0)


def plain_err(w, x, aq, y):
    """max |y - plain| over 1e-5 sum |x||w| (x as the Q8_0 round trip
    gives it): at most 1 if y holds the bar."""
    want = mul_mat_q(w, x, quantize_acts=True)
    scale = dequantize(aq).abs() @ dequantize(w).abs().T
    return float(((y - want).abs() / (1e-5 * scale)).max())


def check(dev, gen):
    """Each build against the plain version at every shape and rows of
    SHAPES and at a ragged 100 x 352 (K % 256 = 96). Raises on a
    disagreement."""
    rows = []
    for name, n, k, bs in SHAPES + [("ragged", 100, 352, (2, 5, 16))]:
        for b in bs:
            (w,), x, aq = inputs(n, k, b, gen, dev)
            row = {"shape": name, "n": n, "k": k, "b": b}
            for v in VARIANTS:
                with variant(v):
                    y = mma_q8_matmul(w, aq)
                row[f"{v}_finite"] = bool(torch.isfinite(y).all())
                row[f"{v}_err_over_bar"] = plain_err(w, x, aq, y)
            row["ok"] = all(row[f"{v}_finite"] and row[f"{v}_err_over_bar"]
                            <= 1.0 for v in VARIANTS)
            rows.append(row)
            if not row["ok"]:
                emit({"q8_acts_check": rows})
                raise RuntimeError(f"a Q8_ACTS build disagrees: {row}")
    emit({"q8_acts_check": rows})
    return rows


def time_variants(dev, gen, reps=100):
    """Each build's ms at each shape and rows of SHAPES, cold L2, in turns
    (i8, bf16, i8, bf16: each the mean of its two runs), and a bf16
    library matmul over the dequantized weight."""
    rows = []
    for name, n, k, bs in SHAPES:
        copies = cold_copies(n * k * 34 // 32)
        for b in bs:
            ws, x, aq = inputs(n, k, b, gen, dev, copies)
            runs = {v: [] for v in VARIANTS}
            for _ in range(2):
                for v in VARIANTS:
                    with variant(v):
                        runs[v].append(time_ms(
                            lambda i: mma_q8_matmul(ws[i % copies], aq),
                            reps))
            wb = [dequantize(w, fused_scales=True).to(torch.bfloat16)
                  for w in ws[:2]]
            xb = dequantize(aq).to(torch.bfloat16)
            row = {"shape": name, "n": n, "k": k, "b": b,
                   "cold_copies": copies,
                   **{f"{v}_ms": sum(t) / 2 for v, t in runs.items()},
                   **{f"{v}_runs_ms": t for v, t in runs.items()},
                   "library_ms": time_ms(
                       lambda i: torch.matmul(xb, wb[i % 2].T), reps)}
            row["bf16_over_i8"] = row["bf16_ms"] / row["i8_ms"]
            rows.append(row)
            emit({"q8_acts_timing": row})
            del ws, wb
            torch.cuda.empty_cache()
    return rows


def plain_check(dev):
    """The CPU run: the plain version (Q8_0 weights, x through the Q8_0
    round trip) against the integer arithmetic the two builds share,
    sum_blocks d_w d_x sum_k q_w q_x; no time is taken."""
    from ..models.gpt2 import random_q8_0

    gen = torch.Generator(dev).manual_seed(0)
    w = random_q8_0(64, 352, gen, dev)
    x = torch.randn((3, 352), generator=gen, device=dev)
    aq = quantize_activations(x, GType.Q8_0)
    qw, qx = w["qs"].to(torch.float64), aq["qs"].to(torch.float64)
    dw, dx = w["d"].to(torch.float64), aq["d"].to(torch.float64)
    blocks = torch.einsum("bjk,njk->bnj", qx.reshape(3, -1, 32),
                          qw.reshape(64, -1, 32))
    ref = torch.einsum("bnj,nj,bj->bn", blocks, dw, dx)
    got = mul_mat_q(w, x, quantize_acts=True).to(torch.float64)
    scale = dequantize(aq).abs().to(torch.float64) \
        @ dequantize(w).abs().to(torch.float64).T
    ratio = float(((got - ref).abs() / (1e-5 * scale)).max())
    emit({"q8_acts_plain": {"device": str(dev), "err_over_bar": ratio,
                            "times": "not measured"}})
    return ratio


def run(dev):
    """Build, check and time both builds on the card; the results."""
    t0 = time.perf_counter()
    logs = build_variants()
    gen = torch.Generator(dev).manual_seed(0)
    res = {"card": card(), "build_s": time.perf_counter() - t0,
           "built": sorted(logs)}
    res["check"] = check(dev, gen)
    res["timing"] = time_variants(dev, gen)
    return res


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type == "cpu":
        plain_check(dev)
        return 0
    res = run(dev)
    emit({"q8_acts": {"card": res["card"], "build_s": res["build_s"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
