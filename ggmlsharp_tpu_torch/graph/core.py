"""Compute-graph layer (port of ggmlsharp_tpu/graph/core.py): ggml's
expression DAG with source-to-source autodiff.

Tensors are DAG nodes with ``op/srcs/grad/is_param`` links; ``build_forward``
sorts them in ggml's topological order; ``build_backward`` constructs the
VJPs as NEW graph nodes, so a backward graph can be differentiated again
(backward of backward: the Hessian-vector products of the reference's
Test1).

Execution: ``Graph.compute()`` stages the DAG into one function of the
input values (the leaf, param and seed nodes, ``op == "none"``), as the JAX
package stages it for ``jax.jit``, and runs it through a
``models.captured.CapturedStep`` held on the Graph: on the card one
captured CUDA graph a (topology, input spec), the topology being the uids
of the inputs and computed nodes, the spec each input's shape, dtype and
device (JAX retraces on a new one). Every compute copies the inputs'
current ``.data`` into the graph's static buffers, so ``set_data``,
``set_f32`` and ``reset`` between computes replay it; ``build_expand``
drops it. Each computed node's ``.data`` becomes a copy of the graph's
output, so a value held from one compute is not changed by the next (as
JAX's arrays are immutable). On the CPU, and inside
``captured.disabled()``, the same function runs eagerly. Shape inference
runs each new node's op on the ``meta`` device, so a builder given
incompatible shapes raises at build time with the op and the operand
shapes.

Seeding protocol as in ggml: ``Graph.reset`` zeros every grad seed, the
caller sets ``f.grad`` to 1 (``set_f32``) and computes the backward graph.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import captured
from ..quant.formats import QTensor

_counter = itertools.count()


class GTensor:
    """A DAG node. A leaf (op 'none') holds a concrete value in ``.data``;
    an interior node holds its op, sources and static kwargs, and after a
    Graph.compute its value in ``.data``."""

    __slots__ = ("uid", "op", "srcs", "kwargs", "data", "grad", "is_param",
                 "name", "_fwd", "shape", "dtype", "device")

    def __init__(self, op, srcs=(), kwargs=None, data=None, name=None,
                 fwd=None):
        self.uid = next(_counter)
        self.op = op
        self.srcs = tuple(srcs)
        self.kwargs = dict(kwargs or {})
        self.data = data
        self.grad = None
        self.is_param = False
        self.name = name or f"{op}_{self.uid}"
        self._fwd = fwd
        self.shape, self.dtype, self.device = _infer_shape(self)

    # graph-building sugar
    def __add__(self, o):
        from . import builders as B

        return B.add(self, B.as_node(o, self.device))

    def __mul__(self, o):
        from . import builders as B

        return B.mul(self, B.as_node(o, self.device))

    def __sub__(self, o):
        from . import builders as B

        return B.sub(self, B.as_node(o, self.device))

    def __neg__(self):
        from . import builders as B

        return B.neg(self)

    def __repr__(self):
        return f"GTensor({self.name}, op={self.op}, shape={self.shape})"


def _meta(node: GTensor):
    """A value of the node's shape and dtype on the meta device."""
    if isinstance(node.data, QTensor):
        return node.data.to("meta")
    return torch.empty(node.shape, dtype=node.dtype, device="meta")


def _infer_shape(node: GTensor):
    """(shape, dtype, device) of a node: a leaf's from its value, an
    interior node's by running its op on the meta device."""
    if node.op == "none":
        d = node.data
        if isinstance(d, QTensor):
            dev = next(iter(d.planes.values())).device
            return d.shape, "quant:" + str(int(d.gtype)), dev
        if d is None:
            return None, None, None
        return tuple(d.shape), d.dtype, d.device
    try:
        out = node._fwd(*[_meta(s) for s in node.srcs], **node.kwargs)
    except Exception as e:
        # fail at BUILDER time with the op and operand shapes, as the
        # reference asserts at build time
        srcs = ", ".join(str(getattr(s, "shape", None)) for s in node.srcs)
        raise ValueError(
            f"ggml op '{node.op}' rejected operand shapes [{srcs}]: {e}"
        ) from e
    dev = next((s.device for s in node.srcs if s.device is not None), None)
    return tuple(out.shape), out.dtype, dev


def as_tensor(value, device=None) -> torch.Tensor:
    """A tensor of ``value``: a tensor stays where it is unless ``device``
    is given; anything else (numpy array, list, number) lands on ``device``,
    the card by default. float64 becomes float32 and int64 int32, as the
    JAX package's jnp.asarray makes them."""
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    t = torch.as_tensor(np.asarray(value))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t.to(resolve_device(device))


def leaf(value, name=None, device=None) -> GTensor:
    """ggml_new_tensor analog: a concrete leaf (a QTensor stays as it is)."""
    if not isinstance(value, QTensor):
        value = as_tensor(value, device)
    elif device is not None:
        value = value.to(device)
    return GTensor("none", data=value, name=name)


def _zeros_leaf(t: GTensor) -> GTensor:
    return leaf(torch.zeros(t.shape, dtype=t.dtype, device=t.device),
                name=f"grad[{t.name}]")


def set_param(t: GTensor) -> GTensor:
    """ggml_set_param: mark trainable, allocate the grad seed."""
    t.is_param = True
    if t.grad is None:
        t.grad = _zeros_leaf(t)
    return t


class Graph:
    """ggml_cgraph analog: topologically ordered nodes and leafs."""

    def __init__(self):
        self.nodes: list[GTensor] = []
        self.leafs: list[GTensor] = []
        self._seen: set[int] = set()
        # perf counters (ggml's perf_runs / perf_time_us)
        self.perf_runs = 0
        self.perf_time_us = 0.0
        self._step = None  # the staged DAG's CapturedStep
        self._key = None  # the topology it was staged for

    def visit(self, t: GTensor):
        """ggml_visit_parents: post-order DFS with set dedup, iterative
        (backward-of-backward graphs get deep)."""
        stack = [(t, False)]
        while stack:
            n, expanded = stack.pop()
            if expanded:
                if n.op == "none" and not n.is_param and n.grad is None:
                    self.leafs.append(n)
                else:
                    self.nodes.append(n)
                continue
            if n.uid in self._seen:
                continue
            self._seen.add(n.uid)
            stack.append((n, True))
            for s in reversed(n.srcs):
                stack.append((s, False))

    def build_expand(self, t: GTensor):
        """ggml_build_forward_expand: add another output to this graph."""
        self.visit(t)
        self._step = None

    def _stage(self):
        """(input nodes, computed nodes, fun(*input tensors) -> the computed
        nodes' values), in the JAX package's order; a QTensor input is
        passed as its planes (sorted by name)."""
        order = self.leafs + [n for n in self.nodes if n.op == "none"] + [
            n for n in self.nodes if n.op != "none"]
        inputs = [n for n in order if n.op == "none"]
        computed = [n for n in order if n.op != "none"]

        def fun(*flat, spec):
            it = iter(flat)
            env = {}
            for n, sp in zip(inputs, spec):
                if sp[0] == "q":
                    env[n.uid] = QTensor(sp[1], sp[2], {
                        name: next(it) for name, _ in sp[3]})
                else:
                    env[n.uid] = next(it)
            outs = []
            with torch.no_grad():
                for n in computed:
                    v = n._fwd(*[env[s.uid] for s in n.srcs], **n.kwargs)
                    env[n.uid] = v
                    outs.append(v.detach())
            return tuple(outs)

        return inputs, computed, fun

    def compute(self):
        """ggml_graph_compute analog: run the staged DAG (captured on the
        card, cached on the topology and the inputs' spec) and store a copy
        of each computed node's value in ``.data``."""
        t0 = time.perf_counter()
        inputs, computed, fun = self._stage()
        key = tuple(n.uid for n in inputs + computed)
        if self._step is None or self._key != key:
            self._step = captured.CapturedStep(fun)
            self._key = key
        flat, spec = _flatten_inputs(inputs)
        vals = self._step(*flat, spec=spec) if computed else ()
        for n, v in zip(computed, vals):
            n.data = v.clone()
        self.perf_runs += 1
        self.perf_time_us += (time.perf_counter() - t0) * 1e6
        return self

    def reset(self):
        """ggml_graph_reset: zero every grad SEED leaf."""
        for n in self.nodes + self.leafs:
            g = n.grad
            if g is not None and g.op == "none" and g.data is not None:
                g.data = torch.zeros_like(g.data)
        return self


def _flatten_inputs(inputs) -> tuple:
    """(the input nodes' tensors, their spec): a QTensor's planes sorted by
    name; the spec holds each input's shape, dtype and device."""
    flat, spec = [], []
    for n in inputs:
        d = n.data
        if isinstance(d, QTensor):
            names = sorted(d.planes)
            flat += [d.planes[k] for k in names]
            spec.append(("q", d.gtype, d.shape, tuple(
                (k, _spec_of(d.planes[k])) for k in names)))
        elif isinstance(d, torch.Tensor):
            flat.append(d)
            spec.append(("t", _spec_of(d)))
        else:
            raise ValueError(f"Graph.compute: input {n.name} holds no "
                             f"tensor ({type(d).__name__})")
    return flat, tuple(spec)


def _spec_of(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def set_f32(t: GTensor, v) -> GTensor:
    """ggml_set_f32 analog: fill a leaf or param with a scalar."""
    t.data = torch.full(t.shape, v, dtype=t.dtype, device=t.device)
    return t


def set_data(t: GTensor, value) -> GTensor:
    """Give a leaf a new value of its shape, on its device."""
    value = as_tensor(value, t.device)
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"set_data: shape {tuple(value.shape)} != {t.shape}")
    t.data = value
    return t


def get_f32_1d(t: GTensor, i: int) -> float:
    """ggml_get_f32_1d analog."""
    return float(t.data.reshape(-1)[i])


def build_forward(t: GTensor) -> Graph:
    g = Graph()
    g.visit(t)
    return g


def build_backward(gf: Graph, keep: bool = False) -> Graph:
    """ggml_build_backward: walk the forward graph in reverse, accumulating
    VJP expression nodes into ``src.grad``. With ``keep=True`` every grad
    becomes a fresh seed, so the previous backward graph's grad tensors
    survive as inputs of the new expressions: build_backward(gb, keep=True)
    then computes Hessian-vector products, as Test1 does."""
    from . import builders as B
    from .op_defs import VJP_TABLE

    gb = Graph()
    gb.nodes = list(gf.nodes)
    gb.leafs = list(gf.leafs)
    gb._seen = set(gf._seen)
    walk = list(gf.nodes)

    # nodes on a path from a param to an output need grads
    need = {n.uid for n in walk if n.is_param}
    changed = True
    while changed:
        changed = False
        for n in walk:
            if n.uid not in need and any(s.uid in need for s in n.srcs):
                need.add(n.uid)
                changed = True

    if keep:
        for n in walk:
            if n.grad is not None:
                n.grad = _zeros_leaf(n)

    for n in walk:
        if n.uid in need and n.grad is None:
            n.grad = _zeros_leaf(n)

    for n in reversed(walk):
        if n.grad is None or n.op == "none":
            continue
        vjp = VJP_TABLE.get(n.op) or _generic_vjp
        for s, gs in zip(n.srcs, vjp(n, n.grad)):
            if gs is None or isinstance(s.data, QTensor):
                continue  # no gradient, or a quantized leaf
            if s.uid not in need and s.grad is None:
                continue  # constants (ggml: a src without grad is skipped)
            if s.grad is None:
                s.grad = _zeros_leaf(s)
            s.grad = B.add(s.grad, gs)

    for n in walk:
        if n.is_param and n.grad is not None:
            gb.build_expand(n.grad)
    return gb


def _vjp_fn(fwd, kwargs, i):
    """The VJP of fwd in its i-th source, as a node function of (*srcs, g).
    The gradient keeps its graph (create_graph), so a VJP node can itself be
    differentiated: by autograd when an objective is staged (optim.opt), and
    by another _generic_vjp node in a backward of a backward."""

    def vjp_i(*vals):
        *src_vals, gval = vals
        with torch.enable_grad():
            x = src_vals[i]
            if not x.requires_grad:
                x = x.detach().requires_grad_()
            sv = list(src_vals)
            sv[i] = x
            out = fwd(*sv, **kwargs)
            return torch.autograd.grad(out, x, gval, create_graph=True)[0]

    return vjp_i


def _generic_vjp(node: GTensor, g: GTensor):
    """The VJP of an op the table has no rule for: one node per floating
    source, each running torch.autograd.grad of the op's function."""
    outs = []
    for i, s in enumerate(node.srcs):
        if isinstance(s.data, QTensor) or isinstance(s.dtype, str) \
                or not s.dtype.is_floating_point:
            outs.append(None)
            continue
        outs.append(GTensor(f"vjp{i}[{node.op}]", srcs=(*node.srcs, g),
                            fwd=_vjp_fn(node._fwd, dict(node.kwargs), i),
                            name=f"vjp{i}[{node.name}]"))
    return outs
