"""ggml_opt facade (port of ggmlsharp_tpu/optim/facade.py): minimize a
graph-layer scalar over its ``set_param`` tensors, or any function of a
parameter tree. The objective's gradient comes from autograd (the JAX
package's jax.value_and_grad)."""
from __future__ import annotations

import torch

from ..graph.core import GTensor, build_forward
from .adam import opt_adam
from .lbfgs import opt_lbfgs
from .params import OptParams, OptResult, OptType
from .tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(fun):
    """x -> (fun(x) detached, the gradient tree of fun at x; zeros where fun
    does not depend on a leaf)."""

    def vg(x):
        xs = tree_map(lambda a: a.detach().requires_grad_(), x)
        with torch.enable_grad():
            f = fun(xs)
        leaves = tree_leaves(xs)
        gs = torch.autograd.grad(f, leaves, allow_unused=True)
        gs = [torch.zeros_like(a) if g is None else g
              for a, g in zip(leaves, gs)]
        return f.detach(), tree_unflatten(xs, gs)

    return vg


def opt_fn(fun, x0, params: OptParams | None = None, callback=None):
    """Functional entry: minimize the scalar fun(tree) from x0. Returns
    (x, f, OptResult, n_iters)."""
    p = params or OptParams()
    vg = value_and_grad(fun)
    if p.type == OptType.ADAM:
        return opt_adam(vg, x0, p, callback)
    return opt_lbfgs(vg, x0, p, callback)


def _stage_objective(f: GTensor):
    """f's forward graph as fun(param values) -> scalar, evaluated under
    autograd."""
    gf = build_forward(f)
    order = gf.leafs + gf.nodes
    param_nodes = [n for n in order if n.is_param]
    const_nodes = [n for n in order if n.op == "none" and not n.is_param]

    def fun(pvals):
        env = {n.uid: v for n, v in zip(param_nodes, pvals)}
        for n in const_nodes:
            env[n.uid] = n.data
        for n in order:
            if n.op != "none":
                env[n.uid] = n._fwd(*[env[s.uid] for s in n.srcs],
                                    **n.kwargs)
        return env[f.uid].reshape(())

    return fun, param_nodes


def opt(f: GTensor, params: OptParams | None = None, callback=None):
    """Graph entry (ggml_opt): minimize the scalar node f over its params;
    the fitted values are written back into the param nodes' ``.data``.
    Returns (OptResult, f)."""
    p = params or OptParams()
    fun, param_nodes = _stage_objective(f)
    if not param_nodes:
        return OptResult.FAIL, None
    x0 = [n.data for n in param_nodes]
    x, fx, res, _ = opt_fn(fun, x0, p, callback)
    for n, v in zip(param_nodes, x):
        n.data = v.detach()
    return res, fx
