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

JAX's ``opt_optax`` jits its step (value, gradient, ``tx.update`` and
``apply_updates``). The port captures it as ``opt_adam`` captures its own
(``models.captured.CapturedStep``, one graph an ``opt_torch`` call): each
gradient is written into a fixed ``leaf.grad`` buffer with ``copy_`` and
``opt.step()`` updates the leaves in place; the first iteration runs
eagerly on the capture stream (the warm-up, which also makes the
optimizer's lazy state) and iterations 2..n replay the graph. So the
optimizer must be capturable: ``GgmlAdam`` is (its step count is a device
tensor); of torch's own, those with a ``capturable`` flag (``Adam``,
``AdamW`` and the others whose step count is a tensor) need
``capturable=True``, or their step raises inside the capture and
``opt_torch`` raises naming the cause. On the CPU, and inside
``captured.disabled()``, the same step runs eagerly.
"""
from __future__ import annotations

import torch

from ..models import captured
from .adam import (_bias_corrections, _clip, _direction, _first_moment,
                   _second_moment, _iterate)
from .params import AdamParams, OptParams
from .tree import tree_leaves, tree_map, tree_unflatten


class GgmlAdam(torch.optim.Optimizer):
    """This package's Adam as a torch.optim.Optimizer: the update math of
    ``optim.adam._adam_step`` (trajectory-equal to ``opt_adam``, tested).
    One step count and one global gradient norm (for ``gclip``) span every
    parameter group; moments are kept in each parameter's dtype. The step
    count is a 0-d f32 tensor on the parameters' device and the moments are
    written in place, so a step can be captured into a CUDA graph."""

    def __init__(self, params, adam: AdamParams | None = None):
        self.adam = adam or AdamParams()
        super().__init__(params, {})
        self._count = None  # the step count, made at the first update

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
            grads = _clip(grads, a.gclip)
        ps = self._params()
        if self._count is None:
            self._count = torch.zeros((), dtype=torch.float32,
                                      device=ps[0].device)
        self._count.add_(1.0)
        bc1, bc2 = _bias_corrections(self._count, a.beta1, a.beta2)
        updates = []
        for i, (p, gi) in enumerate(zip(ps, grads)):
            st = self.state[p]
            if not st:
                st["m"] = torch.zeros_like(p)
                st["v"] = torch.zeros_like(p)
            st["m"].copy_(_first_moment(st["m"], gi, a.beta1))
            st["v"].copy_(_second_moment(st["v"], gi, a.beta2))
            xi = params[i] if params is not None else torch.zeros_like(p)
            updates.append(-a.alpha * _direction(st["m"], st["v"], xi, bc1,
                                                 bc2, a.eps, a.weight_decay))
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
    fun_vg: x -> (f, gradient tree), with no host sync; make_optimizer: the
    list of parameter tensors (x0's leaves, copied) -> an optimizer over
    them, e.g. ``lambda ps: torch.optim.SGD(ps, lr=0.1)``,
    ``lambda ps: GgmlAdam(ps, adam)`` or, on the card,
    ``lambda ps: torch.optim.Adam(ps, capturable=True)``. Returns (x, f,
    OptResult, n_iters), the contract of opt_adam: each iteration evaluates
    f at x, then steps; a stopping rule keeps the stepped x; f is evaluated
    at the final x."""
    p = params or OptParams()
    leaves = [torch.as_tensor(xi, dtype=torch.float32).detach().clone()
              if not isinstance(xi, torch.Tensor) else xi.detach().clone()
              for xi in tree_leaves(x0)]
    for leaf in leaves:
        leaf.grad = torch.zeros_like(leaf)  # written in place every step
    opt = make_optimizer(leaves)

    def current():
        return tree_unflatten(x0, leaves)

    def step():
        f, g = fun_vg(current())
        with torch.no_grad():
            for leaf, gi in zip(leaves, tree_leaves(g)):
                leaf.grad.copy_(gi)
        opt.step()
        return f

    captured_step = captured.CapturedStep(step, device=leaves[0].device,
                                          warm_first_call=True)
    try:
        result, _, it = _iterate(captured_step, p, callback)
    finally:
        captured_step.release()
    x = tree_map(lambda t: t.detach(), current())
    return x, float(fun_vg(x)[0]), result, it
