"""Adam (port of ggmlsharp_tpu/optim/adam.py: ggml_opt_adam).

Bias-corrected Adam over a parameter tree, with the optional global-norm
``gclip`` and decoupled ``weight_decay``, and ggml's three stopping rules:
relative Δf < eps_f, the ``past``-window delta test and max-no-improvement
patience, checked on the loss of each step's parameters before the step.
Moments are kept in each parameter's dtype, as the JAX function keeps them.

JAX jits the step (``_adam_step``: fun_vg, the clip, both moments, the
update and the gradient norm in one executable, ``t`` traced). The port's
counterpart is one captured CUDA graph an ``opt_adam`` call
(``models.captured.CapturedStep``): ``opt_adam`` owns x (a copy of x0), m,
v and the step count t (a 0-d f32 tensor the step advances, so the bias
corrections are computed in f32 on the device, as JAX computes them), and
the step writes them in place. The first iteration runs eagerly on the
capture stream and is the warm-up; iterations 2..n replay the graph,
which is freed before ``opt_adam`` returns. ``fun_vg`` must make no host
sync, as under ``jax.jit``; a step that cannot be captured raises. On the
CPU, and inside ``captured.disabled()``, the same step runs eagerly.
"""
from __future__ import annotations

import torch

from ..models import captured
from .params import OptParams, OptResult
from .tree import tree_leaves, tree_map


def _global_norm(g):
    return torch.sqrt(sum(torch.sum(gi.to(torch.float32) ** 2)
                          for gi in tree_leaves(g)))


def _clip(g, gclip):
    """The gradient tree scaled to global norm at most gclip."""
    scale = torch.clamp(gclip / torch.clamp(_global_norm(g), min=1e-30),
                        max=1.0)
    return tree_map(lambda gi: gi * scale, g)


def _bias_corrections(t, beta1, beta2):
    """(1 - beta1^t, 1 - beta2^t) in f32, t a 0-d f32 tensor."""
    return 1 - beta1 ** t, 1 - beta2 ** t


def _first_moment(mi, gi, beta1):
    return beta1 * mi + (1 - beta1) * gi


def _second_moment(vi, gi, beta2):
    return beta2 * vi + (1 - beta2) * gi * gi


def _direction(mi, vi, xi, bc1, bc2, eps, wd):
    """The bias-corrected step direction with the decoupled decay: the
    update is -alpha times it."""
    return (mi / bc1) / (torch.sqrt(vi / bc2) + eps) + wd * xi


def _adam_step(fun_vg, x, m, v, t, alpha, beta1, beta2, eps, wd, gclip):
    """One step as JAX's function returns it: (x, m, v, f at x, the
    gradient's global norm), new trees; t the step's number (1 for the
    first), a number or a 0-d tensor, taken as f32."""
    x, m, v = (tree_map(torch.clone, a) for a in (x, m, v))
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=tree_leaves(x)[0].device) - 1
    f, gnorm = _adam_step_(fun_vg, x, m, v, t, alpha, beta1, beta2, eps, wd,
                           gclip)
    return x, m, v, f, gnorm


def _adam_step_(fun_vg, x, m, v, t, alpha, beta1, beta2, eps, wd, gclip):
    """_adam_step's arithmetic in place: t advanced by one, then x, m and v
    written by copy_ (never rebound, so a captured graph stays valid).
    Returns (f at x before the step, the gradient's global norm)."""
    f, g = fun_vg(x)
    with torch.no_grad():
        if gclip > 0:
            g = _clip(g, gclip)
        t.add_(1.0)
        bc1, bc2 = _bias_corrections(t, beta1, beta2)
        for xi, mi, vi, gi in zip(tree_leaves(x), tree_leaves(m),
                                  tree_leaves(v), tree_leaves(g)):
            mi.copy_(_first_moment(mi, gi, beta1))
            vi.copy_(_second_moment(vi, gi, beta2))
            xi.copy_(xi - alpha * _direction(mi, vi, xi, bc1, bc2, eps, wd))
        return f, _global_norm(g)


def _as_tensor(a):
    """A copy of a leaf of x0: opt_adam writes its own."""
    return a.detach().clone() if isinstance(a, torch.Tensor) \
        else torch.tensor(a, dtype=torch.float32)


def opt_adam(fun_vg, x0, params: OptParams | None = None, callback=None):
    """Minimize f with Adam. fun_vg: x -> (f, gradient tree), with no host
    sync. x0 is copied, never written. Returns (x, f, OptResult,
    n_iters)."""
    p = params or OptParams()
    a = p.adam
    x = tree_map(_as_tensor, x0)
    m = tree_map(torch.zeros_like, x)
    v = tree_map(torch.zeros_like, x)
    dev = tree_leaves(x)[0].device
    t = torch.zeros((), dtype=torch.float32, device=dev)
    step = captured.CapturedStep(
        lambda: _adam_step_(fun_vg, x, m, v, t, a.alpha, a.beta1, a.beta2,
                            a.eps, a.weight_decay, a.gclip),
        device=dev, warm_first_call=True)
    try:
        result, f, it = _iterate(lambda: step()[0], p, callback)
    finally:
        step.release()  # the graph lives for one call, as JAX's executable
    return x, f, result, it


def _iterate(step, p: OptParams, callback=None):
    """ggml's iterations: ``step()`` (which advances the parameters in
    place) returns the loss before its update, read back once; the
    stopping rules (relative Δf < eps_f, the ``past`` window,
    no-improvement patience) are checked on it. Returns (OptResult, the
    last loss, iterations)."""
    a = p.adam
    fx_prev = None
    fx_best = None
    n_no_improvement = 0
    pf = []  # the past-window of f values

    for it in range(1, a.n_iter + 1):
        f = float(step())  # the step's one host read
        if callback:
            callback(it, f)

        # ggml's convergence checks, on the f before the step was applied
        if fx_prev is not None:
            if abs(f - fx_prev) / max(abs(f), 1e-30) < a.eps_f:
                return OptResult.OK, f, it
        if p.past > 0:
            if len(pf) == p.past:
                rate = (pf[0] - f) / p.past
                if abs(rate) < p.delta:
                    return OptResult.OK, f, it
                pf.pop(0)
            pf.append(f)
        if p.max_no_improvement > 0:
            if fx_best is None or f < fx_best:
                fx_best = f
                n_no_improvement = 0
            else:
                n_no_improvement += 1
                if n_no_improvement >= p.max_no_improvement:
                    return OptResult.OK, f, it

        fx_prev = f

    return OptResult.DID_NOT_CONVERGE, fx_prev, a.n_iter
