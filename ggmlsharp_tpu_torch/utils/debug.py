"""Inspection and checking helpers (port of utils/profiling.py's
graph_print and utils/debug.py): ggml_graph_print, ggml_print_objects, and
the JAX package's checkify wrappers ``checked`` / ``check`` and its
``assert_all_finite`` sweep.

``check(pred, msg, **fmt)`` inside a call wrapped by ``checked(fn)`` records
the predicate (a bool or a one-element tensor, on any device) without
reading it; after the call the wrapper reads the recorded predicates in
order and raises ``CheckError`` (a ``ValueError``, like JAX's
``JaxRuntimeError``) for the first that is false, with the message JAX's
checkify gives: ``msg.format(**fmt)`` followed by `` (`check` failed)``. So a
check costs no host read inside the call. Outside ``checked`` a check reads
its predicate at once and raises, as JAX's does when called eagerly.
"""
from __future__ import annotations

import functools
import threading

import torch

from ..graph.core import Graph
from ..quant.formats import QTensor


class CheckError(ValueError):
    """A failed ``check``."""


_RECORDS = threading.local()  # .stack: one list of checks a ``checked`` call


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) and v.numel() == 1 else v


def _raise_if_false(pred, msg, fmt):
    if not bool(pred):
        raise CheckError(msg.format(**{k: _value(v) for k, v in fmt.items()})
                         + " (`check` failed)")


def checked(fn):
    """Wrap fn so that the ``check``s made inside a call raise after it, the
    first failed one first (the Debug.Assert analog of the JAX package)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        stack = getattr(_RECORDS, "stack", None)
        if stack is None:
            stack = _RECORDS.stack = []
        stack.append([])
        try:
            out = fn(*args, **kwargs)
        finally:
            records = stack.pop()
        for pred, msg, fmt in records:
            _raise_if_false(pred, msg, fmt)
        return out

    return wrapper


def check(pred, msg: str, **fmt):
    """An assertion: recorded for the innermost ``checked`` call, else
    evaluated now."""
    stack = getattr(_RECORDS, "stack", None)
    if stack:
        stack[-1].append((pred, msg, fmt))
    else:
        _raise_if_false(pred, msg, fmt)


def _keystr(path) -> str:
    """A tree path in jax.tree_util.keystr's form: ['key'][0]..."""
    return "".join(f"[{k!r}]" for k in path)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts, lists, tuples, QTensors and
    tensors; None is an empty subtree, as in a JAX pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, QTensor):
        for k, v in tree.planes.items():
            yield from _leaves(v, path + (k,))
    elif tree is not None:
        yield path, tree


def assert_all_finite(tree, name: str = "tree"):
    """Host-side NaN/Inf sweep over a tree of tensors: raises
    FloatingPointError naming every floating leaf that holds a non-finite
    value, by its path; returns True otherwise."""
    bad = [_keystr(path) for path, leaf in _leaves(tree)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return True


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
