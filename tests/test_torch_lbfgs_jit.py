"""The port's device-resident L-BFGS (optim/lbfgs.py::opt_lbfgs_jit) against
the JAX package's opt_lbfgs_jit, on the CPU, where the port's probe step
runs eagerly with the same batching as its captured graph on the card.

Bars: the same OptResult as JAX's jit form; on the quadratic the same
iteration count, on Rosenbrock within 2; x within rtol = atol = 1e-3 (the
bar of the JAX package's own jit-versus-host test). Both packages evaluate
f and its gradient in f32 with their own roundings, so a Rosenbrock
trajectory parts by ~1e-5 after seven iterations and the end points agree
to the bar, not to the ulp. The forced MAXLS and FAIL cases end at the
first iteration and agree exactly. The probe update is traced by
torch.compile with fullgraph=True (Python control flow on a tensor breaks
that trace), and a whole probe runs under a dispatch mode that refuses
every op reading a tensor back to the host: either would break the CUDA
graph capture on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggmlsharp_tpu import compat as J
from ggmlsharp_tpu.graph import builders as JB
from ggmlsharp_tpu.graph import set_data as jset_data
from ggmlsharp_tpu.optim import lbfgs as jlbfgs
from ggmlsharp_tpu.optim import opt_default_params as jdefaults
from ggmlsharp_tpu.optim.params import LineSearch as JLineSearch
from ggmlsharp_tpu.optim.params import OptType as JOptType
from ggmlsharp_tpu_torch import compat as T
from ggmlsharp_tpu_torch.graph import builders as B
from ggmlsharp_tpu_torch.graph import set_data
from ggmlsharp_tpu_torch.optim import (
    LineSearch, OptType, opt_default_params, value_and_grad,
)
from ggmlsharp_tpu_torch.optim import lbfgs
from ggmlsharp_tpu_torch.dtypes import GType

LINE_SEARCHES = ["ARMIJO", "WOLFE", "STRONG_WOLFE"]


def _quad(x, xp):
    return xp.sum((x - xp.arange(4, dtype=xp.float32)) ** 2)


def _rosen(p, xp):
    return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] * p[0]) ** 2


PROBLEMS = {
    "quadratic": (_quad, np.zeros(4, np.float32), 0),
    "rosenbrock": (_rosen, np.array([-1.2, 1.0], np.float32), 2),
}


def _params(ls, **over):
    """The same L-BFGS settings in both packages: n_iter 200, line search
    ``ls``, then ``over`` (lbfgs fields, or past / delta / ...)."""
    out = []
    for defaults, kinds, ltype in ((jdefaults, JLineSearch, JOptType),
                                   (opt_default_params, LineSearch,
                                    OptType)):
        p = defaults(ltype.LBFGS)
        p.lbfgs.n_iter = 200
        p.lbfgs.linesearch = kinds[ls]
        for k, v in over.items():
            setattr(p.lbfgs if hasattr(p.lbfgs, k) else p, k, v)
        out.append(p)
    return out


def _both(fun, x0, ls, **over):
    jp, tp = _params(ls, **over)
    jx, jf, jres, jit_ = jlbfgs.opt_lbfgs_jit(
        jax.value_and_grad(lambda v: fun(v, jnp)), jnp.asarray(x0), jp)
    tx, tf, tres, tit = lbfgs.opt_lbfgs_jit(
        value_and_grad(lambda v: fun(v, torch)), torch.from_numpy(x0), tp)
    return (np.asarray(jx), jf, jres, jit_), (tx.numpy(), tf, tres, tit)


@pytest.mark.parametrize("ls", LINE_SEARCHES)
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_jit_form_matches_jax_jit(problem, ls):
    """Measured: the quadratic to 5e-7 in x at equal iterations; Rosenbrock
    to 4e-6 (Armijo, FAIL at 8 in both), 1e-6 (Wolfe, 37 iterations in
    both) and 0 (strong Wolfe, 39 against 38)."""
    fun, x0, it_slack = PROBLEMS[problem]
    (jx, jf, jres, jit_), (tx, tf, tres, tit) = _both(fun, x0, ls)
    assert tres.name == jres.name
    assert abs(tit - jit_) <= it_slack
    np.testing.assert_allclose(tx, jx, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tf, jf, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ls", LINE_SEARCHES)
@pytest.mark.parametrize("case,over,code", [
    ("maxls", {"max_linesearch": 1}, "LBFGS_MAX_LINESEARCH"),
    ("max_step", {"max_step": 1e-3}, "FAIL"),
    ("min_step", {"min_step": 0.9}, "FAIL"),
    ("n_iter", {"n_iter": 5}, "DID_NOT_CONVERGE"),
])
def test_forced_result_codes_match_jax_jit(case, over, code, ls):
    """Rosenbrock with one line-search probe (MAXLS), a max_step below the
    first step or a min_step above the first backtrack (FAIL), or five
    iterations (DID_NOT_CONVERGE): JAX's code and iteration count, and its
    x (the probe rejected, or five identical iterations)."""
    fun, x0, _ = PROBLEMS["rosenbrock"]
    (jx, _, jres, jit_), (tx, _, tres, tit) = _both(fun, x0, ls, **over)
    assert jres.name == tres.name == code
    assert tit == jit_
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-6)


def _test3_data(np_, nf):
    """Test3's deterministic data (tests/test_torch_optim.py's)."""
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


def _test3_graph(api, bld, sdata, F, lab, ctx):
    NP_, NF = F.shape
    Fl = sdata(api.ggml_new_tensor_2d(ctx, GType.F32, NF, NP_), F)
    ll = sdata(api.ggml_new_tensor_1d(ctx, GType.F32, NP_), lab)
    w = api.ggml_new_tensor_1d(ctx, GType.F32, NF)
    api.ggml_set_param(ctx, w)
    err = api.ggml_sub(ctx, api.ggml_mul_mat(ctx, Fl, w), ll)
    f = api.ggml_add(
        ctx, bld.scale_const(api.ggml_sum(ctx, api.ggml_sqr(ctx, err)),
                             1.0 / NP_),
        bld.scale_const(api.ggml_sum(ctx, api.ggml_sqr(ctx, w)), 1e-5))
    return f, w


def test3_small_via_ggml_opt_matches_jax():
    """Test3 at 256 x 32 through compat.ggml_opt (the port's jit form by
    opt_lbfgs's dispatch) and the JAX package's ggml_opt (optim.opt, its jit
    form): the same result code, weights within 1e-3, every weight within
    1e-2 of +-1; the port's fit read back at most ceil(evaluations / K) + 2
    times and captured nothing on the CPU."""
    F, lab = _test3_data(256, 32)
    jctx = J.ggml_init()
    jf, jw = _test3_graph(J, JB, jset_data, F, lab, jctx)
    jres = J.ggml_opt(jctx, J.ggml_opt_default_params(J.GGML_OPT_LBFGS), jf)
    tctx = T.ggml_init(device="cpu")
    tf, tw = _test3_graph(T, B, set_data, F, lab, tctx)
    lbfgs.reset_counts()
    tres = T.ggml_opt(tctx, T.ggml_opt_default_params(T.GGML_OPT_LBFGS), tf)
    counts = dict(lbfgs.COUNTS)
    assert tres.name == jres.name
    assert tres.name in ("OK", "DID_NOT_CONVERGE")
    np.testing.assert_allclose(tw.data.numpy(), np.asarray(jw.data),
                               atol=1e-3)
    w_true = np.where(np.arange(32) < 16, 1.0, -1.0)
    np.testing.assert_allclose(tw.data.numpy(), w_true, atol=1e-2)
    k = lbfgs.PROBES_PER_READBACK
    assert counts["captures"] == counts["replays"] == 0
    assert 1 < counts["evaluations"]
    assert counts["readbacks"] <= math.ceil(counts["evaluations"] / k) + 2


@pytest.mark.parametrize("callback", [False, True], ids=["none", "given"])
def test_dispatch_matches_jax(monkeypatch, callback):
    """opt_lbfgs takes the jit form without a callback and the host form
    with one, in both packages."""
    taken = {}
    for pkg, mod in (("jax", jlbfgs), ("torch", lbfgs)):
        for form in ("opt_lbfgs_jit", "opt_lbfgs_host"):
            monkeypatch.setattr(
                mod, form,
                lambda *a, _pkg=pkg, _form=form: taken.setdefault(_pkg, _form))
    cb = (lambda it, f: None) if callback else None
    jlbfgs.opt_lbfgs(None, None, None, cb)
    lbfgs.opt_lbfgs(None, None, None, cb)
    want = "opt_lbfgs_host" if callback else "opt_lbfgs_jit"
    assert taken == {"jax": want, "torch": want}


def test_host_form_keeps_its_name_and_results():
    """opt_lbfgs_host is the JAX package's opt_lbfgs_host's counterpart:
    Rosenbrock under Wolfe, the same code and x within 1e-3."""
    fun, x0, _ = PROBLEMS["rosenbrock"]
    jp, tp = _params("WOLFE")
    jx, _, jres, _ = jlbfgs.opt_lbfgs_host(
        jax.value_and_grad(lambda v: fun(v, jnp)), jnp.asarray(x0), jp)
    seen = []
    tx, _, tres, tit = lbfgs.opt_lbfgs_host(
        value_and_grad(lambda v: fun(v, torch)), torch.from_numpy(x0), tp,
        lambda it, f: seen.append(it))
    assert tres.name == jres.name == "OK"
    assert seen == list(range(tit + 1))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3)


def _a_state(ls, past):
    """A state three probes into a Rosenbrock fit, and the next probe's
    x_try, f and gradient."""
    _, tp = _params(ls, past=past, delta=1e-3, max_no_improvement=2)
    vg = lbfgs._flat_vg(value_and_grad(lambda v: _rosen(v, torch)),
                        lambda v: v)
    x0 = torch.tensor([-1.2, 1.0])
    f0, g0 = vg(x0)
    st = lbfgs._init_state(x0, f0, g0, tp)
    x_try = torch.empty_like(x0)
    for _ in range(3):
        lbfgs._probe(st, x_try, vg, tp)
    x_try = st["x"] + st["step"] * st["d"]
    return st, x_try, *vg(x_try), tp


class _NoHostSync(TorchDispatchMode):
    """Raises on the ops that read a tensor back to the host: .item(),
    float(), int() and bool() of a tensor (aten._local_scalar_dense), and
    the data-dependent shapes of nonzero and boolean-mask indexing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bool_index = func is torch.ops.aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if bool_index or func in (torch.ops.aten._local_scalar_dense.default,
                                  torch.ops.aten.nonzero.default):
            raise RuntimeError(f"host sync: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("ls,past", [("ARMIJO", 0), ("WOLFE", 3),
                                     ("STRONG_WOLFE", 3)])
def test_probe_update_has_no_host_sync(ls, past):
    """torch.compile(fullgraph=True) traces the update in one graph (Python
    control flow on a tensor would break the trace), the traced update
    gives the eager one's state, and a whole probe (f, its gradient by
    autograd, the update) runs with no op that reads back to the host."""
    st, x_try, f, g, p = _a_state(ls, past)
    st2 = {k: v.clone() for k, v in st.items()}
    want = lbfgs._probe_update(st, x_try, f, g, p)
    traced = torch.compile(
        lambda s, x, fv, gv: lbfgs._probe_update(s, x, fv, gv, p),
        backend="eager", fullgraph=True)
    got = traced(st2, x_try, f, g)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    vg = lbfgs._flat_vg(value_and_grad(lambda v: _rosen(v, torch)),
                        lambda v: v)
    with _NoHostSync():
        lbfgs._probe(st, torch.empty_like(x_try), vg, p)


def test_a_host_sync_fails_both_checks():
    """The control of the checks above: the update followed by the host
    loop's test ``if dginit > 0`` fails the fullgraph trace, and float() of
    a state entry fails the no-sync mode."""
    st, x_try, f, g, p = _a_state("WOLFE", 0)

    def branched(s, x, fv, gv):
        new = lbfgs._probe_update(s, x, fv, gv, p)
        return new if new["dginit"] > 0 else s

    with pytest.raises(torch._dynamo.exc.Unsupported):
        torch.compile(branched, backend="eager", fullgraph=True)(
            st, x_try, f, g)
    with pytest.raises(RuntimeError, match="host sync"), _NoHostSync():
        float(lbfgs._probe_update(st, x_try, f, g, p)["fx"])


@pytest.mark.parametrize("ended_by", ["status", "n_iter"])
def test_finished_fit_ignores_non_finite_probes(ended_by):
    """Once the status leaves RUNNING or the iterations reach n_iter, a
    probe whose f and gradient are NaN or inf changes no entry of the
    state."""
    st, x_try, _, g, p = _a_state("WOLFE", 3)
    if ended_by == "status":
        st["status"].fill_(lbfgs._OK)
    else:
        st["it"].fill_(p.lbfgs.n_iter)
    before = {k: v.clone() for k, v in st.items()}
    nan_g = torch.full_like(g, float("nan"))
    for f in (torch.tensor(float("nan")), torch.tensor(float("inf"))):
        new = lbfgs._probe_update(st, x_try * float("inf"), f, nan_g, p)
        for k in before:
            torch.testing.assert_close(new[k], before[k], rtol=0, atol=0,
                                       equal_nan=True)
