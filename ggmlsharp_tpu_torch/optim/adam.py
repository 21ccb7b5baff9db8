"""Adam (port of ggmlsharp_tpu/optim/adam.py: ggml_opt_adam).

Bias-corrected Adam over a parameter tree, with the optional global-norm
``gclip`` and decoupled ``weight_decay``, and ggml's three stopping rules:
relative Δf < eps_f, the ``past``-window delta test and max-no-improvement
patience, checked on the loss of each step's parameters before the step.
Moments are kept in each parameter's dtype, as the JAX function keeps them.
"""
from __future__ import annotations

import torch

from .params import OptParams, OptResult
from .tree import tree_leaves, tree_map


def _global_norm(g):
    return torch.sqrt(sum(torch.sum(gi.to(torch.float32) ** 2)
                          for gi in tree_leaves(g)))


def _adam_step(fun_vg, x, m, v, t, alpha, beta1, beta2, eps, wd, gclip):
    """One step: (x, m, v, f at x, the gradient's global norm)."""
    f, g = fun_vg(x)
    with torch.no_grad():
        if gclip > 0:
            scale = torch.clamp(gclip / torch.clamp(_global_norm(g), min=1e-30),
                                max=1.0)
            g = tree_map(lambda gi: gi * scale, g)
        m = tree_map(lambda mi, gi: beta1 * mi + (1 - beta1) * gi, m, g)
        v = tree_map(lambda vi, gi: beta2 * vi + (1 - beta2) * gi * gi, v, g)
        bc1 = 1 - beta1 ** t
        bc2 = 1 - beta2 ** t
        x = tree_map(lambda xi, mi, vi: xi - alpha * (
            (mi / bc1) / (torch.sqrt(vi / bc2) + eps) + wd * xi), x, m, v)
        return x, m, v, f, _global_norm(g)


def _as_tensor(a):
    return a.detach() if isinstance(a, torch.Tensor) \
        else torch.as_tensor(a, dtype=torch.float32)


def opt_adam(fun_vg, x0, params: OptParams | None = None, callback=None):
    """Minimize f with Adam. fun_vg: x -> (f, gradient tree).
    Returns (x, f, OptResult, n_iters)."""
    p = params or OptParams()
    a = p.adam
    x = tree_map(_as_tensor, x0)
    m = tree_map(torch.zeros_like, x)
    v = tree_map(torch.zeros_like, x)

    fx_prev = None
    fx_best = None
    n_no_improvement = 0
    pf = []  # the past-window of f values

    for it in range(1, a.n_iter + 1):
        x_new, m, v, f, _ = _adam_step(
            fun_vg, x, m, v, float(it), a.alpha, a.beta1, a.beta2, a.eps,
            a.weight_decay, a.gclip)
        f = float(f)
        if callback:
            callback(it, f)

        # ggml's convergence checks, on the f before the step was applied
        if fx_prev is not None:
            if abs(f - fx_prev) / max(abs(f), 1e-30) < a.eps_f:
                return x_new, f, OptResult.OK, it
        if p.past > 0:
            if len(pf) == p.past:
                rate = (pf[0] - f) / p.past
                if abs(rate) < p.delta:
                    return x_new, f, OptResult.OK, it
                pf.pop(0)
            pf.append(f)
        if p.max_no_improvement > 0:
            if fx_best is None or f < fx_best:
                fx_best = f
                n_no_improvement = 0
            else:
                n_no_improvement += 1
                if n_no_improvement >= p.max_no_improvement:
                    return x_new, f, OptResult.OK, it

        fx_prev = f
        x = x_new

    return x, fx_prev, OptResult.DID_NOT_CONVERGE, a.n_iter
