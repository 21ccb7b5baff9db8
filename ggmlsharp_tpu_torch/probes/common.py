"""What the probes and the autotuner share: the card's identity, timing by
CUDA-graph replay, the card's published rates, JSON output."""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..device import resolve_device

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_S = 67e12     # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2**20


def emit(obj):
    print(json.dumps(obj), flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps, warmup=3):
    """Mean device ms a call of fn(i), i = 0..reps-1 (i picks the caller's
    input copy, so a caller can rotate copies past the L2). The calls are
    captured into one CUDA graph and its replay timed with CUDA events: the
    host's per-call overhead stays out."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_copies(nbytes: int) -> int:
    """Copies of an input of ``nbytes`` to rotate so that each call finds
    it outside the L2 (four times the cache between two uses)."""
    return max(2, -(-4 * L2_BYTES // max(nbytes, 1)))


def bound_ms(nbytes: float, flops: float = 0.0):
    """The least time of a call that moves ``nbytes`` and does ``flops``
    f32 operations: (ms, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def q4_bytes(b: int, n: int, k: int) -> int:
    """Bytes a Q4_0 matmul must move: the packed weight, x and y once."""
    return n * k * 18 // 32 + b * k * 4 + b * n * 4


def parse_device(argv, description):
    """The probes' command line: --device (default: the card)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain versions only, "
                         "at a small size, untimed")
    return resolve_device(ap.parse_args(argv).device)
