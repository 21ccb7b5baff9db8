"""L-BFGS with backtracking line search (port of
ggmlsharp_tpu/optim/lbfgs.py: ggml_opt_lbfgs and its
linesearch_backtracking).

m-history two-loop recursion; Armijo, Wolfe or strong-Wolfe backtracking;
convergence on ‖g‖/max(1, ‖x‖) < eps, plus the shared ``past``-window delta
test and max-no-improvement patience, over the parameters flattened to one
f32 vector on their device. Two forms, under the JAX package's names:

  * ``opt_lbfgs_jit``: device-resident. Each probe (one evaluation of f and
    its gradient, and every decision of the line search and of the outer
    iteration that follows it) is one branch-free step on 0-d tensors, the
    history in fixed [m, n] circular buffers. "jit" here means: on a CUDA
    tensor the step is captured once into a CUDA graph and replayed in
    batches of ``PROBES_PER_READBACK`` probes, with one status word read
    back a batch; on the CPU the same step runs eagerly with the same
    batching. The JAX form's ``lax.while_loop`` is the reference: where it
    and the host loop differ, this form follows it.
  * ``opt_lbfgs_host``: a host loop, each scalar test read back; supports a
    per-iteration callback.

``opt_lbfgs`` dispatches as JAX's does: the jit form unless a callback is
given. ``COUNTS`` counts evaluations, host readbacks, graph captures and
replays; ``reset_counts`` zeroes it.
"""
from __future__ import annotations

import math

import torch

from ..models.captured import collector_off
from .params import LineSearch, OptParams, OptResult
from .tree import tree_leaves, tree_unflatten

# Probes a batch between two readbacks of the status word (jit form).
PROBES_PER_READBACK = 8
# Eager runs of the step on a side stream before capture (autograd's
# backward is captured only after a warm-up); the state is restored after.
WARMUP_PROBES = 2

COUNTS = {"evaluations": 0, "readbacks": 0, "captures": 0, "replays": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _read(t) -> float:
    """One scalar read back to the host."""
    COUNTS["readbacks"] += 1
    return float(t)


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


def _flat_vg(fun_vg, unflatten):
    def vg(xf):
        f, g = fun_vg(unflatten(xf))
        return f.to(torch.float32), _flatten(g)[0]

    return vg


# device status codes (mapped to OptResult on exit), as JAX's
_RUNNING, _OK, _FAIL, _MAXLS, _NOCONV = 0, 1, 2, 3, 4
_STATUS_MAP = {
    _OK: OptResult.OK,
    _FAIL: OptResult.FAIL,
    _MAXLS: OptResult.LBFGS_MAX_LINESEARCH,
    _NOCONV: OptResult.DID_NOT_CONVERGE,
}


def _init_state(x0f, fx0, g0, p: OptParams) -> dict:
    """The fit's state after the first evaluation: every entry a tensor on
    x0f's device (scalars 0-d)."""
    lp = p.lbfgs
    dev, f32, i64 = x0f.device, torch.float32, torch.int64
    n = x0f.shape[0]
    gnorm0 = torch.linalg.norm(g0)
    converged0 = gnorm0 / torch.clamp(torch.linalg.norm(x0f), min=1.0) \
        <= lp.eps

    def i(v):
        return torch.tensor(v, dtype=i64, device=dev)

    d = -g0
    return dict(
        x=x0f.clone(), g=g0.clone(), fx=fx0.clone(), d=d,
        step=1.0 / torch.clamp(gnorm0, min=1e-30),
        dginit=torch.dot(g0, d),
        count=i(0), it=i(0), nfev=i(1),
        status=torch.where(converged0, i(_OK), i(_RUNNING)),
        s_buf=torch.zeros((lp.m, n), dtype=f32, device=dev),
        y_buf=torch.zeros((lp.m, n), dtype=f32, device=dev),
        hlen=i(0), hpos=i(0),
        pf=torch.zeros((max(p.past, 1),), dtype=f32, device=dev),
        pf_len=i(0), fx_best=fx0.clone(), n_noimp=i(0),
    )


def _row(buf, idx):
    return torch.index_select(buf, 0, idx.reshape(1)).squeeze(0)


def _two_loop(g, s_buf, y_buf, hlen, hpos, m):
    """-H·g by the m-history two-loop recursion, unrolled over m with hlen
    masks (JAX's form). Logical entry i (newest first) lives at slot
    (hpos - 1 - i) mod m."""
    slots = torch.arange(m, device=g.device)
    alphas = torch.zeros((m,), dtype=g.dtype, device=g.device)
    rhos = torch.zeros_like(alphas)
    q = g
    for i in range(m):
        idx = (hpos - 1 - i) % m
        s, y = _row(s_buf, idx), _row(y_buf, idx)
        ys = torch.dot(y, s)
        nz = ys != 0
        rho = torch.where(nz, 1.0 / torch.where(nz, ys, 1.0), 0.0)
        alpha = rho * torch.dot(s, q)
        upd = (i < hlen) & (rho != 0)
        q = torch.where(upd, q - alpha * y, q)
        at = slots == idx
        alphas = torch.where(at, torch.where(upd, alpha, 0.0), alphas)
        rhos = torch.where(at, torch.where(upd, rho, 0.0), rhos)
    last = (hpos - 1) % m
    y_last = _row(y_buf, last)
    yy = torch.dot(y_last, y_last)
    ys = torch.dot(y_last, _row(s_buf, last))
    q = q * torch.where(yy > 0, ys / torch.where(yy > 0, yy, 1.0), 1.0)
    for i in range(m):
        idx = (hpos - hlen + i) % m
        rho = _row(rhos, idx)
        beta = rho * torch.dot(_row(y_buf, idx), q)
        q = torch.where((i < hlen) & (rho != 0),
                        q + _row(s_buf, idx) * (_row(alphas, idx) - beta), q)
    return -q


def _probe_update(st: dict, x_try, f_try, g_try, p: OptParams) -> dict:
    """One probe's decisions, given f and its gradient at x_try = x + step·d:
    the line search's test and width (JAX's linesearch body); where the line
    search ends, the rest of JAX's outer iteration (result code, the
    convergence tests, the past window, the history write at hpos, the
    two-loop, the next direction). Branch-free: every choice is a
    torch.where, so a probe made after the fit ended (which may be inf or
    NaN) leaves the state as it was. Returns the new state; the history rows
    are written into st's s_buf and y_buf in place."""
    lp = p.lbfgs
    m, past = lp.m, p.past
    x, g, fx, d = st["x"], st["g"], st["fx"], st["d"]
    step, dginit, status, it = st["step"], st["dginit"], st["status"], st["it"]
    active = (status == _RUNNING) & (it < lp.n_iter)

    # the line search's test (JAX's linesearch body)
    count = st["count"] + 1
    armijo_fail = f_try > fx + step * (lp.ftol * dginit)
    if lp.linesearch == LineSearch.ARMIJO:
        ok = ~armijo_fail
        width = torch.full_like(step, 0.5)
    else:
        dg = torch.dot(g_try, d)
        curv_low = dg < lp.wolfe * dginit
        ok = ~armijo_fail & ~curv_low
        if lp.linesearch == LineSearch.WOLFE:
            width = torch.where(armijo_fail, 0.5, 2.1)
        else:
            ok = ok & ~(dg > -lp.wolfe * dginit)
            width = torch.where(armijo_fail | ~curv_low, 0.5, 2.1)
    if lp.max_linesearch < 1:  # JAX makes no probe: the search fails
        ok = torch.zeros_like(ok)
    new_step = torch.where(ok, step, step * width)
    fail_rng = ~ok & ((new_step < lp.min_step) | (new_step > lp.max_step))
    ls_end = ok | fail_rng | (count >= lp.max_linesearch)
    end = active & ls_end  # an outer iteration completes with this probe
    accepted = end & ok & ~(dginit > 0)

    # the outer iteration's end (JAX's run body after its line search)
    x_n = torch.where(accepted, x_try, x)
    g_n = torch.where(accepted, g_try, g)
    fx_n = torch.where(accepted, f_try, fx)
    code = torch.where((dginit > 0) | fail_rng, _FAIL,
                       torch.where(~ok, _MAXLS, status))
    conv = torch.linalg.norm(g_n) / torch.clamp(torch.linalg.norm(x_n),
                                                min=1.0) <= lp.eps
    pf, pf_len = st["pf"], st["pf_len"]
    if past > 0:
        full = pf_len == past
        conv = conv | (full & (torch.abs((pf[0] - fx_n) / past) < p.delta))
        pf_n = torch.where(full, torch.roll(pf, -1), pf)
        pf_len_n = torch.where(full, pf_len, pf_len + 1)
        at = torch.arange(past, device=pf.device) == \
            torch.clamp(pf_len_n - 1, max=past - 1)
        pf_n = torch.where(at, fx_n, pf_n)
    else:
        pf_n, pf_len_n = pf, pf_len
    improved = fx_n < st["fx_best"]
    n_noimp = torch.where(improved, 0, st["n_noimp"] + 1)
    if p.max_no_improvement > 0:
        conv = conv | (n_noimp >= p.max_no_improvement)
    code = torch.where((code == _RUNNING) & accepted & conv, _OK, code)

    hpos, hlen = st["hpos"], st["hlen"]
    s_buf, y_buf = st["s_buf"], st["y_buf"]
    at_h = hpos.reshape(1)
    s_buf.index_copy_(0, at_h, torch.where(accepted, x_n - x,
                                           _row(s_buf, hpos))[None])
    y_buf.index_copy_(0, at_h, torch.where(accepted, g_n - g,
                                           _row(y_buf, hpos))[None])
    hpos_n = torch.where(accepted, (hpos + 1) % m, hpos)
    hlen_n = torch.where(accepted, torch.clamp(hlen + 1, max=m), hlen)
    d_n = torch.where(accepted,
                      _two_loop(g_n, s_buf, y_buf, hlen_n, hpos_n, m), d)

    def on_end(new, old):
        return torch.where(end, new, old)

    return dict(
        x=x_n, g=g_n, fx=fx_n, d=d_n,
        step=torch.where(accepted, 1.0, torch.where(active, new_step, step)),
        dginit=torch.where(accepted, torch.dot(g_n, d_n), dginit),
        count=torch.where(active, torch.where(ls_end, 0, count),
                          st["count"]),
        it=on_end(it + 1, it),
        nfev=st["nfev"] + (active & (lp.max_linesearch >= 1)).long(),
        status=on_end(code, status),
        s_buf=s_buf, y_buf=y_buf, hlen=hlen_n, hpos=hpos_n,
        pf=on_end(pf_n, pf), pf_len=on_end(pf_len_n, pf_len),
        fx_best=on_end(torch.where(improved, fx_n, st["fx_best"]),
                       st["fx_best"]),
        n_noimp=on_end(n_noimp, st["n_noimp"]),
    )


def _probe(st, x_try, vg, p):
    """One probe on static buffers: x_try and every state entry are written
    in place (copy_), never rebound, so a captured graph stays valid."""
    x_try.copy_(st["x"] + st["step"] * st["d"])
    f_try, g_try = vg(x_try)
    new = _probe_update(st, x_try, f_try, g_try, p)
    for k, v in new.items():
        if v is not st[k]:
            st[k].copy_(v)


def _capture(st, x_try, vg, p):
    """The probe captured into a CUDA graph, after WARMUP_PROBES eager runs
    on a side stream; the state is restored after the warm-up. Raises
    RuntimeError, naming the cause, if fun_vg cannot be captured."""
    saved = {k: v.clone() for k, v in st.items()}
    side = torch.cuda.Stream(device=x_try.device)
    side.wait_stream(torch.cuda.current_stream(x_try.device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_PROBES):
            _probe(st, x_try, vg, p)
    torch.cuda.current_stream(x_try.device).wait_stream(side)
    for k, v in saved.items():
        st[k].copy_(v)
    graph = torch.cuda.CUDAGraph()
    try:
        with collector_off(), torch.cuda.graph(graph):
            _probe(st, x_try, vg, p)
    except RuntimeError as e:
        cause = e  # the first error of the capture, not capture_end's
        while isinstance(cause.__context__, RuntimeError):
            cause = cause.__context__
        raise RuntimeError(
            "opt_lbfgs_jit: the probe step (fun_vg and the L-BFGS update) "
            "could not be captured into a CUDA graph; fun_vg must make no "
            "host sync (.item(), float(), bool() of a tensor, .cpu(), "
            "boolean-mask indexing) and use only capturable ops "
            "(opt_lbfgs_host runs such a function). Cause: "
            f"{str(cause).splitlines()[0]}") from e
    COUNTS["captures"] += 1
    return graph


def opt_lbfgs_jit(fun_vg, x0, params: OptParams | None = None):
    """Minimize f with the device-resident L-BFGS (JAX's opt_lbfgs_jit):
    nothing is read back within a probe. fun_vg: x -> (f, gradient tree)
    with no host sync; x0: a tree of float tensors. Returns (x, f,
    OptResult, n_iters); RUNNING at the end is DID_NOT_CONVERGE."""
    p = params or OptParams()
    lp = p.lbfgs
    x_flat, unflatten = _flatten(x0)
    vg = _flat_vg(fun_vg, unflatten)
    fx0, g0 = vg(x_flat)
    COUNTS["evaluations"] += 1
    st = _init_state(x_flat, fx0, g0, p)
    x_try = torch.empty_like(x_flat)
    if x_flat.is_cuda:
        graph = _capture(st, x_try, vg, p)

        def probe():
            graph.replay()
            COUNTS["replays"] += 1
    else:
        def probe():
            _probe(st, x_try, vg, p)

    max_batches = math.ceil(lp.n_iter * max(lp.max_linesearch, 1)
                            / PROBES_PER_READBACK) + 1
    for _ in range(max_batches):
        for _ in range(PROBES_PER_READBACK):
            probe()
        COUNTS["readbacks"] += 1
        if bool((st["status"] != _RUNNING) | (st["it"] >= lp.n_iter)):
            break
    COUNTS["readbacks"] += 1
    fx, status, it, nfev = torch.stack([
        st["fx"].double(), st["status"].double(), st["it"].double(),
        st["nfev"].double()]).tolist()
    COUNTS["evaluations"] += int(nfev) - 1
    status = int(status)
    return (unflatten(st["x"]), fx,
            _STATUS_MAP[_NOCONV if status == _RUNNING else status], int(it))


def opt_lbfgs(fun_vg, x0, params: OptParams | None = None, callback=None):
    """Minimize f. fun_vg: x -> (f, gradient tree); x0: a tree of float
    tensors. Returns (x, f, OptResult, n_iters). The device-resident form
    unless a per-iteration callback is given (JAX's dispatch)."""
    if callback is None:
        return opt_lbfgs_jit(fun_vg, x0, params)
    return opt_lbfgs_host(fun_vg, x0, params, callback)


def opt_lbfgs_host(fun_vg, x0, params: OptParams | None = None,
                   callback=None):
    """Minimize f on a host loop: one evaluation a probe, each scalar test
    read back to the host. fun_vg: x -> (f, gradient tree); x0: a tree of
    float tensors. Returns (x, f, OptResult, n_iters)."""
    p = params or OptParams()
    lp = p.lbfgs
    m = lp.m

    x_flat, unflatten = _flatten(x0)

    vg = _flat_vg(fun_vg, unflatten)

    def vg_counted(xf):
        COUNTS["evaluations"] += 1
        return vg(xf)

    def dot(a, b):
        return _read(torch.dot(a, b))

    fx, g = vg_counted(x_flat)
    fx = _read(fx)
    if callback:
        callback(0, fx)

    xnorm = _read(torch.linalg.norm(x_flat))
    gnorm = _read(torch.linalg.norm(g))
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
            f_try, g_try = vg_counted(x_try)
            f_try = _read(f_try)
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
        xnorm = _read(torch.linalg.norm(x_flat))
        gnorm = _read(torch.linalg.norm(g))
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
