"""The port's optimizers against the JAX package's, on the CPU: the
reference's Test2 (Adam on four objectives, through the graph facade and
the functional entry), Test3 (L-BFGS on the 4096 x 256 regularised linear
classifier), Rosenbrock under each line search, the past window and AdamW
with gclip.

Both packages run the same objective from the same start. Each step of an
f32 trajectory differs in summation order alone, so the per-iteration
losses agree to rtol 1e-4 over the first 200 steps (a near-zero loss to
1e-7); over thousands of steps the trajectories part by ulps, so the end
points are held to the reference's own criteria in both packages and to
each other within those criteria. L-BFGS takes few, large steps: the two
fits agree to 1e-4 and return the same result code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.graph import builders as JB
from ggmlsharp_tpu.graph import leaf as jleaf
from ggmlsharp_tpu.graph import set_param as jset_param
from ggmlsharp_tpu.optim import opt as jopt
from ggmlsharp_tpu.optim import opt_default_params as jdefaults
from ggmlsharp_tpu.optim import opt_fn as jopt_fn
from ggmlsharp_tpu.optim.lbfgs import opt_lbfgs_host as jlbfgs
from ggmlsharp_tpu.optim.params import LineSearch as JLineSearch
from ggmlsharp_tpu.optim.params import OptParams as JOptParams
from ggmlsharp_tpu.optim.params import OptType as JOptType
from ggmlsharp_tpu_torch.graph import builders as B
from ggmlsharp_tpu_torch.graph import leaf, set_param
from ggmlsharp_tpu_torch.optim import (
    LineSearch, OptParams, OptResult, OptType, opt, opt_default_params,
    opt_fn,
)

XI = np.arange(1, 11, dtype=np.float32)
YI = 10 * XI + 5
N = 10


def _adam(pkg):
    p = JOptParams() if pkg == "jax" else OptParams()
    p.adam.alpha = 0.01  # Test2's override
    return p


def _trace():
    fs = []
    return fs, lambda it, f: fs.append(f)


def _same_start(fa, fb, n=200):
    a, b = np.asarray(fa[:n]), np.asarray(fb[:n])
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def _line_fit_graph(pkg):
    if pkg == "jax":
        Bm, mk, sp = JB, lambda a: jleaf(jnp.asarray(a)), jset_param
    else:
        Bm, mk, sp = B, lambda a: leaf(a, device="cpu"), set_param
    t0, t1 = sp(mk(np.zeros(1, np.float32))), sp(mk(np.zeros(1, np.float32)))
    f = Bm.div(Bm.sum(Bm.sqr(Bm.sub(Bm.add(
        Bm.mul(mk(XI), Bm.repeat(t1, (N,))), Bm.repeat(t0, (N,))),
        mk(YI)))), mk(np.full(1, 2.0 * N, np.float32)))
    return f, t0, t1


def test2_adam_least_squares_graph():
    """f = sum((t0 + t1*x - y)^2) / (2n) from (0, 0), through ggml_opt's
    graph facade: t0 = 5, t1 = 10 within 1e-3."""
    out = {}
    for pkg, run in (("jax", jopt), ("torch", opt)):
        f, t0, t1 = _line_fit_graph(pkg)
        fs, cb = _trace()
        res, fx = run(f, _adam(pkg), cb)
        out[pkg] = (res.name, fs, float(t0.data[0]), float(t1.data[0]))
    (jr, jfs, j0, j1), (tr, tfs, p0, p1) = out["jax"], out["torch"]
    assert jr == tr == "OK"
    _same_start(tfs, jfs)
    for t0, t1 in ((j0, j1), (p0, p1)):
        assert abs(t0 - 5.0) < 1e-3 and abs(t1 - 10.0) < 1e-3


def _l1(t, xp):
    xi, yi = xp.asarray(XI), xp.asarray(YI)
    return 0.5 * xp.sum(xp.abs(t[0] + t[1] * xi - yi)) / N


def _quadratic(t, xp):
    return (5 * t[0] + t[1] - 35.0) ** 2 + (t[0] + 8 * t[1] - 42.0) ** 2


def _booth(t, xp):
    return (t[0] + 2 * t[1] - 7.0) ** 2 + (2 * t[0] + t[1] - 5.0) ** 2


@pytest.mark.parametrize("fun,x0,check", [
    (_l1, (-1.0, 9.0), lambda x, f: abs(x[0] - 5) < 1e-2 and abs(x[1] - 10) < 1e-2),
    (_quadratic, (1.0, 1.0), lambda x, f: f < 1e-3),
    (_booth, (0.0, 0.0), lambda x, f: abs(x[0] - 1) < 1e-2 and abs(x[1] - 3) < 1e-2),
], ids=["l1_fit", "quadratic", "booth"])
def test2_adam_functional(fun, x0, check):
    jx, jf, jres, _ = jopt_fn(
        lambda p: fun(p, jnp), tuple(jnp.float32(v) for v in x0),
        _adam("jax"), (jfs := _trace())[1])
    tx, tf, tres, _ = opt_fn(
        lambda p: fun(p, torch), tuple(torch.tensor(v) for v in x0),
        _adam("torch"), (tfs := _trace())[1])
    assert jres.name == tres.name == "OK"
    _same_start(tfs[0], jfs[0])
    assert check([float(v) for v in jx], jf)
    assert check([float(v) for v in tx], tf)


def _test3_data(np_, nf):
    """Test3's deterministic data: MSVC-LCG noise over a block-indicator
    design (the JAX test's _test3_data, with Python integers)."""
    state = 0
    F = np.zeros((np_, nf), np.float32)
    lab = np.where(np.arange(np_) < np_ // 2, 1.0, -1.0).astype(np.float32)
    for j in range(np_):
        for i in range(nf):
            state = (214013 * state + 2531011) & 0xFFFFFFFF
            r = (state >> 16) & 0x7FFF
            ind = 1.0 if (lab[j] > 0) == (i < nf // 2) else 0.0
            F[j, i] = (ind + (r / 32767.0 - 0.5) * 0.1) / (0.5 * nf)
    return F, lab


def test3_lbfgs_linear_classifier():
    """Full-scale Test3 (NP 4096, NF 256): the L2-regularised least-squares
    fit through ggml_opt's graph facade with L-BFGS, every weight within
    1e-2 of +1 (first half) or -1; the port's fit against JAX's host loop
    on the same data."""
    NP_, NF = 4096, 256
    F, lab = _test3_data(NP_, NF)
    w = set_param(leaf(np.zeros(NF, np.float32), device="cpu"))
    err = B.sub(B.mul_mat(leaf(F, device="cpu"), w), leaf(lab, device="cpu"))
    f = B.add(B.scale_const(B.sum(B.sqr(err)), 1.0 / NP_),
              B.scale_const(B.sum(B.sqr(w)), 1e-5))
    res, fx = opt(f, opt_default_params(OptType.LBFGS))
    assert res in (OptResult.OK, OptResult.DID_NOT_CONVERGE)
    w_true = np.where(np.arange(NF) < NF // 2, 1.0, -1.0)
    np.testing.assert_allclose(w.data.numpy(), w_true, atol=1e-2)

    Fj, lj = jnp.asarray(F), jnp.asarray(lab)

    def jfun(wv):
        return jnp.sum((Fj @ wv - lj) ** 2) / NP_ + 1e-5 * jnp.sum(wv * wv)

    jw, jfx, jres, _ = jlbfgs(jax.value_and_grad(jfun),
                              jnp.zeros(NF, jnp.float32),
                              jdefaults(JOptType.LBFGS))
    assert jres.name == res.name
    np.testing.assert_allclose(w.data.numpy(), np.asarray(jw), atol=1e-4)
    np.testing.assert_allclose(fx, jfx, rtol=1e-4)


@pytest.mark.parametrize("ls", ["ARMIJO", "WOLFE", "STRONG_WOLFE"])
def test_lbfgs_rosenbrock_matches_jax_host(ls):
    """Rosenbrock from (-1.2, 1) under each line search: the minimum (1, 1)
    within 1e-3, and the JAX host loop's result code and end point."""
    def rosen(p, xp):
        return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] * p[0]) ** 2

    jp = jdefaults(JOptType.LBFGS)
    jp.lbfgs.n_iter = 200
    jp.lbfgs.linesearch = JLineSearch[ls]
    jx, _, jres, _ = jlbfgs(jax.value_and_grad(lambda v: rosen(v, jnp)),
                            jnp.asarray([-1.2, 1.0], jnp.float32), jp)
    tp = opt_default_params(OptType.LBFGS)
    tp.lbfgs.n_iter = 200
    tp.lbfgs.linesearch = LineSearch[ls]
    tx, _, tres, _ = opt_fn(lambda v: rosen(v, torch),
                            torch.tensor([-1.2, 1.0]), tp)
    assert tres.name == jres.name
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3)
    if ls != "ARMIJO":  # Armijo alone may stop short of the valley's end
        np.testing.assert_allclose(tx.numpy(), [1.0, 1.0], atol=1e-3)


def test_adam_past_window_stops_early():
    """past = 3, delta = 1e-3: the window rule stops Adam early, at the
    JAX iteration."""
    out = []
    for pkg, run, x0 in (("jax", jopt_fn, jnp.asarray([1.0, -2.0])),
                         ("torch", opt_fn, torch.tensor([1.0, -2.0]))):
        p = JOptParams() if pkg == "jax" else OptParams()
        p.past, p.delta, p.adam.n_iter = 3, 1e-3, 5000
        xp = jnp if pkg == "jax" else torch
        _, fx, res, iters = run(lambda t: xp.sum(t * t), x0, p)
        out.append((res.name, iters, fx))
    (jr, ji, jf), (tr, ti, tf) = out
    assert jr == tr == "OK" and ti == ji < 5000
    np.testing.assert_allclose(tf, jf, rtol=1e-4)


def test_adamw_weight_decay_and_gclip():
    """Decoupled decay shrinks weights under a zero gradient; gclip bounds a
    huge gradient's step. Both trajectories equal JAX's."""
    res = {}
    for pkg in ("jax", "torch"):
        xp, run = (jnp, jopt_fn) if pkg == "jax" else (torch, opt_fn)
        p = JOptParams() if pkg == "jax" else OptParams()
        p.adam.n_iter, p.adam.alpha = 50, 0.1
        p.adam.weight_decay, p.adam.gclip = 0.1, 1.0
        p.max_no_improvement, p.past = 0, 0
        ones = jnp.ones((3,)) if pkg == "jax" else torch.ones(3)
        w, _, _, _ = run(lambda v: xp.sum(v * 0.0), ones, p)
        p2 = JOptParams() if pkg == "jax" else OptParams()
        p2.adam.n_iter, p2.adam.alpha, p2.adam.gclip = 3, 0.5, 1e-3
        zeros = jnp.zeros((2,)) if pkg == "jax" else torch.zeros(2)
        w2, _, _, _ = run(lambda v: 1e6 * xp.sum(v * v + v), zeros, p2)
        res[pkg] = (np.asarray(w), np.asarray(w2))
    assert float(np.abs(res["torch"][0]).max()) < 1.0  # decayed toward 0
    assert np.isfinite(res["torch"][1]).all()
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
