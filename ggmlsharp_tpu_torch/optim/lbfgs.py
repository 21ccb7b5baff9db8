"""L-BFGS with backtracking line search (port of
ggmlsharp_tpu/optim/lbfgs.py::opt_lbfgs_host: ggml_opt_lbfgs and its
linesearch_backtracking).

m-history two-loop recursion; Armijo, Wolfe or strong-Wolfe backtracking;
convergence on ‖g‖/max(1, ‖x‖) < eps, plus the shared ``past``-window delta
test and max-no-improvement patience. The loop runs on the host, one
evaluation of f and its gradient a probe, over the parameters flattened to
one f32 vector on their device. (The JAX package's ``opt_lbfgs_jit``, the
same iteration staged into one TPU while_loop, is not ported.)
"""
from __future__ import annotations

import torch

from .params import LineSearch, OptParams, OptResult
from .tree import tree_leaves, tree_unflatten


def _flatten(x):
    leaves = tree_leaves(x)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])

    def unflatten(v):
        out, off = [], 0
        for s in shapes:
            n = 1
            for d in s:
                n *= d
            out.append(v[off:off + n].reshape(s))
            off += n
        return tree_unflatten(x, out)

    return flat, unflatten


def opt_lbfgs(fun_vg, x0, params: OptParams | None = None, callback=None):
    """Minimize f. fun_vg: x -> (f, gradient tree); x0: a tree of float
    tensors. Returns (x, f, OptResult, n_iters)."""
    p = params or OptParams()
    lp = p.lbfgs
    m = lp.m

    x_flat, unflatten = _flatten(x0)

    def vg(xf):
        f, g = fun_vg(unflatten(xf))
        return f.to(torch.float32), _flatten(g)[0]

    def dot(a, b):
        return float(torch.dot(a, b))

    fx, g = vg(x_flat)
    fx = float(fx)
    if callback:
        callback(0, fx)

    xnorm = float(torch.linalg.norm(x_flat))
    gnorm = float(torch.linalg.norm(g))
    if gnorm / max(1.0, xnorm) <= lp.eps:
        return unflatten(x_flat), fx, OptResult.OK, 0

    d = -g  # initial direction: steepest descent
    step = 1.0 / max(gnorm, 1e-30)

    s_hist = []  # x_{k+1} - x_k
    y_hist = []  # g_{k+1} - g_k
    pf = []
    fx_best = fx
    n_no_improvement = 0

    for it in range(1, lp.n_iter + 1):
        xp, gp, fxp = x_flat, g, fx

        # --- backtracking line search -----------------------------------
        dginit = dot(gp, d)
        if dginit > 0:
            return unflatten(x_flat), fx, OptResult.FAIL, it
        dec, inc = 0.5, 2.1
        count = 0
        finit = fxp
        dgtest = lp.ftol * dginit
        ok = False
        while count < lp.max_linesearch:
            x_try = xp + step * d
            f_try, g_try = vg(x_try)
            f_try = float(f_try)
            count += 1
            if f_try > finit + step * dgtest:
                width = dec
            elif lp.linesearch == LineSearch.ARMIJO:
                ok = True
            else:
                dg = dot(g_try, d)
                if dg < lp.wolfe * dginit:
                    width = inc
                elif lp.linesearch == LineSearch.WOLFE:
                    ok = True
                elif dg > -lp.wolfe * dginit:
                    width = dec
                else:
                    ok = True
            if ok:
                break
            step *= width
            if step < lp.min_step or step > lp.max_step:
                return unflatten(xp), fxp, OptResult.FAIL, it
        if not ok:
            return unflatten(xp), fxp, OptResult.LBFGS_MAX_LINESEARCH, it

        x_flat, g, fx = x_try, g_try, f_try
        if callback:
            callback(it, fx)

        # --- convergence ------------------------------------------------
        xnorm = float(torch.linalg.norm(x_flat))
        gnorm = float(torch.linalg.norm(g))
        if gnorm / max(1.0, xnorm) <= lp.eps:
            return unflatten(x_flat), fx, OptResult.OK, it
        if p.past > 0:
            if len(pf) == p.past:
                rate = (pf[0] - fx) / p.past
                if abs(rate) < p.delta:
                    return unflatten(x_flat), fx, OptResult.OK, it
                pf.pop(0)
            pf.append(fx)
        if p.max_no_improvement > 0:
            if fx < fx_best:
                fx_best = fx
                n_no_improvement = 0
            else:
                n_no_improvement += 1
                if n_no_improvement >= p.max_no_improvement:
                    return unflatten(x_flat), fx, OptResult.OK, it

        # --- history and the two-loop recursion -------------------------
        s_hist.append(x_flat - xp)
        y_hist.append(g - gp)
        if len(s_hist) > m:
            s_hist.pop(0)
            y_hist.pop(0)

        q = g
        alphas = []
        for s, y in zip(reversed(s_hist), reversed(y_hist)):
            ys = dot(y, s)
            if ys == 0.0:
                alphas.append((0.0, 0.0))
                continue
            rho = 1.0 / ys
            alpha = rho * dot(s, q)
            q = q - alpha * y
            alphas.append((rho, alpha))
        yy = dot(y_hist[-1], y_hist[-1])
        ys = dot(y_hist[-1], s_hist[-1])
        q = q * (ys / yy if yy > 0 else 1.0)
        for (rho, alpha), (s, y) in zip(reversed(alphas), zip(s_hist, y_hist)):
            if rho == 0.0:
                continue
            beta = rho * dot(y, q)
            q = q + s * (alpha - beta)

        d = -q
        step = 1.0

    return unflatten(x_flat), fx, OptResult.DID_NOT_CONVERGE, lp.n_iter
