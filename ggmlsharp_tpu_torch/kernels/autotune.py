"""Time every compiled launch geometry of the three dequant-matmul kernels on
the card and write the winners to the tune table (counterpart of
scripts/autotune_swar.py).

For each (key, N, K) of the benchmark models' shapes: Q4_0 and Q8_0
(``matmul_q4_0:NxK``, ``matmul_q8_0:NxK``) at the 7B, GPT-2 124M and 13B
shapes, with the port's real LM heads (32000 and 50257 rows, not the TPU's
padded 32256 / 51200); every format of kernel A (``g<int>:NxK``) at the 7B
shapes. Each geometry the kernel is compiled for (``tune.GEOMETRIES_OF``) is
timed at b = 1 as ``probes.common.time_ms`` does (CUDA-graph replay, a
different weight copy a launch so the L2 is cold), ROUNDS times in turns.
The run-to-run spread of a shape is the larger range of the default's and
the winner's samples; only a winner whose median beats the default's by
more than that spread goes into the table, else the default stays. The
table gets ``_card`` (nvidia-smi's name and power limit) and ``_sweep_s``
(the sweep's wall time); each shape's record gives every pair's median and
range.

Every geometry gives the same bits (kernels/tune.py), so the table moves
time only. The sweep times the sources' b = 1 instance (RB = 1) only, so
dispatch reads the table at b = 1 only: a launch of more rows runs the
sources' multi-row instance, which takes no geometry.

Run on the card:
  python -m ggmlsharp_tpu_torch.kernels.autotune [--out PATH]
(default PATH: the packaged tune_h100.json). With --device cpu it prints
the sweep's plan and times nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from ..device import resolve_device
from ..dtypes import GType
from ..quant.formats import QTensor, plane_specs
from . import tune

SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
             (32000, 4096)]
SHAPES_GPT2 = [(2304, 768), (768, 768), (3072, 768), (768, 3072),
               (50257, 768)]
SHAPES_13B = [(15360, 5120), (5120, 5120), (27648, 5120), (5120, 13824),
              (32000, 5120)]
SHAPES = SHAPES_7B + SHAPES_GPT2 + SHAPES_13B
KERNEL_FORMATS = {"matmul_q4_0": GType.Q4_0, "matmul_q8_0": GType.Q8_0}
GTYPE_TARGETS = [GType.Q6_K, GType.Q5_0, GType.Q5_1, GType.Q4_K, GType.Q4_1,
                 GType.Q4_2, GType.Q4_3]
ROUNDS = 5
TARGET_MS = 2.0  # device time of one timed replay


def targets():
    """(key, kernel, gtype, n, k) for every entry the sweep measures."""
    out = [(f"{kern}:{n}x{k}", kern, g, n, k)
           for kern, g in KERNEL_FORMATS.items() for n, k in SHAPES]
    out += [(f"g{int(g)}:{n}x{k}", "matmul_q", g, n, k)
            for g in GTYPE_TARGETS for n, k in SHAPES_7B]
    return out


def random_copies(gtype, n: int, k: int, gen, dev):
    """Copies of a random [n, k] weight of ``gtype``, together at least
    four times the L2, each plane a view into one buffer a plane (random
    bits; f16 scales in [0.5, 1.5)/k so values stay finite). Values do not
    move a kernel's time."""
    from ..probes.common import cold_copies

    specs = plane_specs(gtype, k)
    one = sum(torch.empty((), dtype=dt).element_size() * cols
              for dt, cols in specs.values()) * n
    copies = min(cold_copies(one), 512)
    bufs = {}
    for name, (dt, cols) in specs.items():
        shape = (copies * n, cols)
        if dt == torch.float16:
            bufs[name] = ((torch.rand(shape, generator=gen, device=dev) + 0.5)
                          / k).to(torch.float16)
        elif dt == torch.float32:
            bufs[name] = torch.rand(shape, generator=gen, device=dev)
        else:
            bits = torch.randint(0, 256, (shape[0], cols
                                          * torch.empty((), dtype=dt)
                                          .element_size()),
                                 generator=gen, device=dev,
                                 dtype=torch.uint8)
            bufs[name] = bits.view(dt)
    return [QTensor(gtype, (n, k), {name: b[i * n:(i + 1) * n]
                                    for name, b in bufs.items()})
            for i in range(copies)]


def launcher(kernel: str):
    """fn(x, w, geom) launching ``kernel`` at an explicit geometry."""
    from . import matmul_q as mq

    if kernel == "matmul_q4_0":
        return lambda x, w, g: mq.q4_0_matmul(x, w["qs"], w["d"], g)
    if kernel == "matmul_q8_0":
        return lambda x, w, g: mq.q8_0_matmul(x, w["qs"], w["d"], g)
    return lambda x, w, g: mq.q_matmul(x, w, g)


def sweep_one(kernel, gtype, n, k, gen, dev, rounds=ROUNDS):
    """Every geometry's ms samples at one shape, b = 1."""
    from ..probes.common import time_ms

    ws = random_copies(gtype, n, k, gen, dev)
    copies = len(ws)
    x = torch.randn((1, k), generator=gen, device=dev)
    fn = launcher(kernel)
    wbytes = ws[0].nbytes()
    reps = int(min(400, max(20, TARGET_MS * 1e-3 * 2.5e12 / wbytes)))
    samples = {g: [] for g in tune.GEOMETRIES_OF[kernel]}
    for _ in range(rounds):
        for g in samples:
            samples[g].append(time_ms(lambda i: fn(x, ws[i % copies], g),
                                      reps))
    del ws
    return samples, reps, wbytes


def decide(samples):
    """(winner, default median, winner median, spread): the winner enters
    the table only if it beats the default by more than the spread."""
    med = {g: statistics.median(v) for g, v in samples.items()}
    best = min(med, key=med.get)
    d = tune.DEFAULT
    spread = max(max(samples[d]) - min(samples[d]),
                 max(samples[best]) - min(samples[best]))
    return best, med[d], med[best], spread


def run(out_path: str, dev):
    from ..probes.common import card, emit
    from . import _build

    t0 = time.perf_counter()
    _build.build(list(tune.KERNELS))
    gen = torch.Generator(dev).manual_seed(0)
    table = {"_card": card()}
    rows = []
    for key, kernel, g, n, k in targets():
        samples, reps, wbytes = sweep_one(kernel, g, n, k, gen, dev)
        best, dmed, bmed, spread = decide(samples)
        enter = best != tune.DEFAULT and dmed - bmed > spread
        row = {"key": key, "reps": reps, "weight_bytes": wbytes,
               "median_ms": {f"{w}x{r}": statistics.median(v)
                             for (w, r), v in samples.items()},
               "range_ms": {f"{w}x{r}": max(v) - min(v)
                            for (w, r), v in samples.items()},
               "default_ms": dmed, "best": list(best), "best_ms": bmed,
               "spread_ms": spread, "entered": enter}
        rows.append(row)
        emit({"autotune": row})
        if enter:
            table[key] = [best[0], best[1], round(bmed * 1e3, 2),
                          round(dmed * 1e3, 2)]
        torch.cuda.empty_cache()
    table["_sweep_s"] = round(time.perf_counter() - t0, 1)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    entered = sum(r["entered"] for r in rows)
    emit({"autotune_done": {"out": out_path, "measured": len(rows),
                            "entered": entered, "card": table["_card"],
                            "sweep_s": table["_sweep_s"]}})
    return table, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=tune.PACKAGED)
    ap.add_argument("--device", default=None,
                    help="cuda (default); cpu prints the plan only")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        print(json.dumps({"autotune_plan": {
            "keys": [t[0] for t in targets()],
            "geometries": {k: [list(g) for g in tune.GEOMETRIES_OF[k]]
                           for k in tune.KERNELS},
            "rounds": ROUNDS, "times": "not measured"}}), flush=True)
        return 0
    run(args.out, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
