"""Inspection helpers (port of utils/profiling.py's graph_print and
utils/debug.py's print_objects): ggml_graph_print and ggml_print_objects.
The JAX package's checkify wrappers (``checked``, ``check``) have no
counterpart: PyTorch runs eagerly and raises where it fails."""
from __future__ import annotations

from ..graph.core import Graph
from ..quant.formats import QTensor


def graph_print(graph: Graph) -> str:
    """ggml_graph_print analog: structure and perf counters."""
    lines = ["=== GRAPH ===",
             f"n_nodes = {len(graph.nodes)}",
             f"n_leafs = {len(graph.leafs)}",
             f"perf_runs = {graph.perf_runs}, "
             f"total_us = {graph.perf_time_us:.0f}"]
    for i, n in enumerate(graph.nodes):
        lines.append(
            f" - {i:3}: {str(n.shape):<20} {n.op:<14} "
            f"{'param' if n.is_param else ''}"
            f"{' grad' if n.grad is not None else ''}")
    for i, n in enumerate(graph.leafs):
        lines.append(f" - leaf {i:3}: {str(n.shape):<20} {n.name}")
    out = "\n".join(lines)
    print(out)
    return out


def _walk(tree, path=""):
    """(path, leaf) pairs of a tree of dicts, lists, tuples and tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def print_objects(tree, name: str = "params") -> str:
    """ggml_print_objects analog: each tensor's shape, dtype and bytes."""
    lines = [f"=== {name} ==="]
    total = 0
    for path, t in _walk(tree):
        if isinstance(t, QTensor):
            nb = t.nbytes()
            lines.append(f" - {path:<40} QTensor[{t.gtype.name}] {t.shape} "
                         f"({nb / 1e6:.2f} MB packed)")
        elif t is None:
            nb = 0
            lines.append(f" - {path:<40} None")
        else:
            nb = t.numel() * t.element_size()
            lines.append(f" - {path:<40} {str(t.dtype):<10} "
                         f"{tuple(t.shape)} ({nb / 1e6:.2f} MB)")
        total += nb
    lines.append(f"total: {total / 1e6:.2f} MB")
    out = "\n".join(lines)
    print(out)
    return out
