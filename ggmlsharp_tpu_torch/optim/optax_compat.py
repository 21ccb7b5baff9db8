"""torch.optim interop for the ggml-parity optimizers (port of
ggmlsharp_tpu/optim/optax_compat.py; the file keeps its name so a reader
finds the counterpart).

Two directions, as in the JAX package:

  * ``GgmlAdam(params, adam_params)`` (JAX: ``as_optax(adam_params)``) —
    this package's Adam (``optim.adam._adam_step``'s math: optional
    global-norm grad clip, bias-corrected moments, decoupled weight decay
    inside the update) as a ``torch.optim.Optimizer``, drop-in for any
    PyTorch training loop. ``update(grads, params)`` is the optax-style
    half: it advances the state and returns the updates without applying
    them, and refuses ``weight_decay`` without ``params``.
  * ``opt_torch(fun_vg, x0, make_optimizer, params)`` (JAX:
    ``opt_optax(fun_vg, x0, tx, params)``) — ggml's stopping rules
    (relative Δf < eps_f, the ``past``-window delta test, max-no-improvement
    patience) driving ANY ``torch.optim.Optimizer``. A PyTorch optimizer is
    bound to its tensors, so it is passed as a factory: ``opt_torch`` hands
    it the parameter leaves it made from ``x0``.

JAX's ``opt_optax`` jits its step; the port runs it eagerly.
"""
from __future__ import annotations

import torch

from .params import AdamParams, OptParams, OptResult
from .tree import tree_leaves, tree_map, tree_unflatten


class GgmlAdam(torch.optim.Optimizer):
    """This package's Adam as a torch.optim.Optimizer: the update math of
    ``optim.adam._adam_step`` (trajectory-equal to ``opt_adam``, tested).
    One step count and one global gradient norm (for ``gclip``) span every
    parameter group; moments are kept in each parameter's dtype."""

    def __init__(self, params, adam: AdamParams | None = None):
        self.adam = adam or AdamParams()
        super().__init__(params, {})
        self._count = 0

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def update(self, grads, params=None) -> list:
        """The optax-style update: advance the state by one step on
        ``grads`` (one tensor a parameter, in parameter-group order) and
        return the updates, the tensors to add to the parameters. The
        decoupled weight decay reads ``params`` (ValueError without them
        when ``weight_decay`` > 0)."""
        a = self.adam
        if params is None and a.weight_decay > 0:
            raise ValueError("weight_decay needs params passed to update()")
        grads = list(grads)
        if a.gclip > 0:
            gn = torch.sqrt(sum(torch.sum(gi.to(torch.float32) ** 2)
                                for gi in grads))
            scale = torch.clamp(a.gclip / torch.clamp(gn, min=1e-30), max=1.0)
            grads = [gi * scale for gi in grads]
        self._count += 1
        t = float(self._count)
        bc1 = 1 - a.beta1 ** t
        bc2 = 1 - a.beta2 ** t
        updates = []
        for i, (p, gi) in enumerate(zip(self._params(), grads)):
            st = self.state[p]
            if not st:
                st["m"] = torch.zeros_like(p)
                st["v"] = torch.zeros_like(p)
            st["m"] = a.beta1 * st["m"] + (1 - a.beta1) * gi
            st["v"] = a.beta2 * st["v"] + (1 - a.beta2) * gi * gi
            xi = params[i] if params is not None else torch.zeros_like(p)
            updates.append(-a.alpha * ((st["m"] / bc1)
                                       / (torch.sqrt(st["v"] / bc2) + a.eps)
                                       + a.weight_decay * xi))
        return updates

    @torch.no_grad()
    def step(self, closure=None):
        """One Adam step on the parameters' ``.grad`` (a missing gradient
        counts as zeros); returns the closure's loss, if given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        ps = self._params()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in ps]
        for p, u in zip(ps, self.update(grads, ps)):
            p.add_(u)
        return loss


def opt_torch(fun_vg, x0, make_optimizer, params: OptParams | None = None,
              callback=None):
    """Minimize f with any torch.optim.Optimizer under ggml's stopping rules.
    fun_vg: x -> (f, gradient tree); make_optimizer: the list of parameter
    tensors (x0's leaves, copied) -> an optimizer over them, e.g.
    ``lambda ps: torch.optim.SGD(ps, lr=0.1)`` or
    ``lambda ps: GgmlAdam(ps, adam)``. Returns (x, f, OptResult, n_iters),
    the contract of opt_adam: each iteration evaluates f at x, then steps;
    a stopping rule keeps the stepped x; f is evaluated at the final x."""
    p = params or OptParams()
    a = p.adam  # stopping knobs (n_iter/eps_f/past/max_no_improvement)
    leaves = [torch.as_tensor(xi, dtype=torch.float32).detach().clone()
              if not isinstance(xi, torch.Tensor) else xi.detach().clone()
              for xi in tree_leaves(x0)]
    opt = make_optimizer(leaves)

    def current():
        return tree_unflatten(x0, leaves)

    def step():
        f, g = fun_vg(current())
        for leaf, gi in zip(leaves, tree_leaves(g)):
            leaf.grad = gi.detach().to(leaf.dtype)
        opt.step()
        return float(f)

    fx_prev = fx_best = None
    n_no_improvement = 0
    pf = []
    result = OptResult.DID_NOT_CONVERGE
    it = 0
    for it in range(1, a.n_iter + 1):
        f = step()
        if callback:
            callback(it, f)
        if fx_prev is not None:
            if abs(f - fx_prev) / max(abs(f), 1e-30) < a.eps_f:
                result = OptResult.OK
                break
        if p.past > 0:  # identical to opt_adam's window-rate test
            if len(pf) == p.past:
                if abs((pf[0] - f) / p.past) < p.delta:
                    result = OptResult.OK
                    break
                pf.pop(0)
            pf.append(f)
        if p.max_no_improvement > 0:
            if fx_best is None or f < fx_best:
                fx_best, n_no_improvement = f, 0
            else:
                n_no_improvement += 1
                if n_no_improvement >= p.max_no_improvement:
                    result = OptResult.OK
                    break
        fx_prev = f
    x = tree_map(lambda t: t.detach(), current())
    return x, float(fun_vg(x)[0]), result, it
