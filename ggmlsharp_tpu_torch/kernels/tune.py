"""Measured launch geometry of the dequant-matmul kernels, per weight shape
(port of ggmlsharp_tpu/kernels/tune.py).

The three dequant-matmul sources (``csrc/matmul_q4_0.cu``,
``matmul_q8_0.cu``, ``matmul_q.cu``) are compiled for every pair
(warps a block, weight rows a warp) of their kernel's ``GEOMETRIES_OF``:
``GEOMETRIES`` for Q8_0, ``VEC_GEOMETRIES`` (those and three 16-warp pairs)
for the b = 1 streaming instance of the other two (``csrc/dq_vec.cuh``,
whose second number is the rows a warp's group). The pair is the port's
counterpart of the JAX package's per-shape (tile, nc, kp). Every pair gives
the same bits: a row's lane partial sums and their shuffle tree depend on
neither number, so the choice moves time only. ``kernels/autotune.py``
times every pair on the card at the benchmark models' shapes and writes the
winners here; the matmul wrappers (``kernels.matmul_q.geometry``) read the
table at dispatch and launch ``DEFAULT`` where it holds nothing.

Table file: ``GGML_TPU_TUNE`` if set, else the packaged ``tune_h100.json``
beside this module (the JAX package's ``tune_v5e.json`` does not carry over:
its choices are a TPU's). Schema:

    {"<kernel>:NxK": [warps, rows_per_warp, ...],
     "g<gtype int>:NxK": [warps, rows_per_warp, ...],
     "_card": "<nvidia-smi name, power limit>"}

A format's ``g<int>`` entry wins over its kernel's entry, as the JAX
``g<int>`` wins over ``kt<B>``; fields past the first two (the autotuner's
microseconds) are diagnostics. An entry that is not a pair compiled into
its kernel, a missing file or bad JSON gives None, and the wrapper then launches the
default pair of the same kernel, as the JAX lookup falls back to its
heuristic.

The table is read once per path, as the JAX lookup reads it, and each
(path, kernel, N, K, format) answer is kept, so a launch pays one
environment read and one cache hit. The entries were timed at b = 1, the
sources' decode instance (RB = 1); the wrappers read them only there.
"""
from __future__ import annotations

import functools
import json
import os

# (warps a block, rows a warp) compiled into each dequant-matmul source;
# the b = 1 streaming instance of matmul_q4_0.cu and matmul_q.cu
# (csrc/dq_vec.cuh: warps a CTA, rows a group) also at 16 warps
GEOMETRIES = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4))
VEC_GEOMETRIES = GEOMETRIES + ((16, 1), (16, 2), (16, 4))
DEFAULT = (4, 2)
KERNELS = ("matmul_q4_0", "matmul_q8_0", "matmul_q")
GEOMETRIES_OF = {"matmul_q4_0": VEC_GEOMETRIES, "matmul_q8_0": GEOMETRIES,
                 "matmul_q": VEC_GEOMETRIES}
PACKAGED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tune_h100.json")


@functools.lru_cache(maxsize=8)
def _load(path: str) -> dict:
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    return table if isinstance(table, dict) else {}


def table_path() -> str:
    return os.environ.get("GGML_TPU_TUNE") or PACKAGED


def table() -> dict:
    """The table in force (read once per path)."""
    return _load(table_path())


def legal(entry, kernel=None) -> tuple[int, int] | None:
    """The (warps, rows_per_warp) of a table entry if it is a pair compiled
    into ``kernel`` (None: into every source), else None."""
    if not isinstance(entry, (list, tuple)) or len(entry) < 2:
        return None
    try:
        pair = (int(entry[0]), int(entry[1]))
    except (TypeError, ValueError):
        return None
    return pair if pair in GEOMETRIES_OF.get(kernel, GEOMETRIES) else None


def lookup(kernel: str, n: int, k: int, gtype=None):
    """Measured (warps, rows_per_warp) for kernel ``kernel`` at an [n, k]
    weight, or None to launch the default. A format's entry
    ("g<int>:NxK") wins over the kernel's ("<kernel>:NxK")."""
    return _lookup(table_path(), kernel, n, k,
                   None if gtype is None else int(gtype))


@functools.lru_cache(maxsize=None)
def _lookup(path, kernel, n, k, gtype):
    t = _load(path)
    ent = None
    if gtype is not None:
        ent = t.get(f"g{gtype}:{n}x{k}")
    if ent is None:
        ent = t.get(f"{kernel}:{n}x{k}")
    if ent is None:
        return None
    return legal(ent, kernel)  # None: stale or corrupt, the default runs
