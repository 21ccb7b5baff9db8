"""Per-op profiling rollup (port of ggmlsharp_tpu/utils/profiling.py:
OpProfiler; ggml_graph_print's per-op totals, Ggml.cs:2888-2936).

``OpProfiler`` computes a Graph node by node and times each node's op
alone, over ``iters`` runs after a warm-up run: CUDA events around the runs
on the card, ``time.perf_counter`` around a synchronised call on the CPU.
It keeps ``per_node`` (name, op, µs) and ``report()`` (a per-node table and
a per-op rollup), and bumps ``graph.perf_runs``. Each node's value is
stored, detached, in its ``.data``, as ``Graph.compute`` stores it.
``graph_print`` stays in ``utils/debug.py``.

The JAX package jits each node to time it; the port runs eagerly, so a
node's time is its op's launches (and, for an op that is a kernel of this
package, that kernel's).
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

from ..graph.core import Graph


def _time_us(fn, iters: int, device: torch.device) -> tuple:
    """(the last output, µs a run) of ``iters`` runs of fn after one
    warm-up run."""
    out = fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) * 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return out, (time.perf_counter() - t0) / iters * 1e6


class OpProfiler:
    """Compute a Graph node by node, collecting each node's time."""

    def __init__(self, iters: int = 3):
        if iters < 1:
            raise ValueError(f"OpProfiler: iters {iters}")
        self.iters = iters
        self.per_node: list[tuple[str, str, float]] = []  # (name, op, us)

    def compute(self, graph: Graph) -> Graph:
        """Run every interior node in topological order, timed; store its
        value in ``.data``."""
        with torch.no_grad():
            for n in graph.nodes:
                if n.op == "none":
                    continue
                args = [s.data for s in n.srcs]
                out, us = _time_us(
                    lambda: n._fwd(*args, **n.kwargs).detach(), self.iters,
                    torch.device(n.device or "cpu"))
                n.data = out
                self.per_node.append((n.name, n.op, us))
        graph.perf_runs += 1
        return graph

    def report(self) -> str:
        lines = ["=== per-node profile ==="]
        for name, op, us in self.per_node:
            lines.append(f"  {name:<32} {op:<14} {us:10.1f} us")
        lines.append("=== per-op rollup ===")
        for op, us in sorted(self.rollup().items(), key=lambda kv: -kv[1]):
            lines.append(f"  {op:<14} {us:10.1f} us")
        return "\n".join(lines)

    def rollup(self) -> dict:
        """{op: total µs} over the profiled nodes."""
        totals = defaultdict(float)
        for _, op, us in self.per_node:
            totals[op] += us
        return dict(totals)

