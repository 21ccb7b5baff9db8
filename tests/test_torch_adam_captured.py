"""The port's Adam in its captured form (optim/adam.py: x, m, v and the
step count t owned by ``opt_adam`` and written in place by one step that
the card captures into a CUDA graph; the bias corrections in f32 from the
device count) against the JAX package's jitted ``_adam_step``, on the CPU,
where the same step runs eagerly through the same buffers.

Bars: an f32 trajectory differs from JAX's in summation order alone (both
now compute the bias corrections in f32 from an f32 t), so the loss of
every iteration agrees to rtol 1e-5, with and without ``gclip`` and
``weight_decay``; the end point to rtol 1e-4 / atol 1e-5, since Adam's
m / sqrt(v) divides out a gradient's scale and so lifts an element whose
gradient is near 0 to a relative difference of ~1e-4 (measured ≤ 6.2e-5
relative, 3.4e-6 absolute after 12 steps). Each stopping rule ends both
packages at the same iteration with the same result: each case is one
where the rule's statistic stays at least 10% from its bar at every
iteration up to the stop (``_rule_margin``; for the no-improvement count,
every loss at least 1e-3 from the best so far), while the two
trajectories' losses stay within 1e-4 of each other over those 19-28
steps (measured 3.6e-5), so an ulp cannot move the iteration. The
host-sync check runs a whole step of a small GPT-2's and a small Llama's
``lm_loss`` (forward, autograd's backward, the clip, both moments, the
update) under a dispatch mode that refuses every read back to the host
and every tensor made from host data (a host-to-device copy on the card),
as a CUDA graph capture would; its controls show the mode firing.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.graph import builders as JB
from ggmlsharp_tpu.graph import leaf as jleaf
from ggmlsharp_tpu.graph import set_param as jset_param
from ggmlsharp_tpu.optim import opt as jopt
from ggmlsharp_tpu.optim import opt_fn as jopt_fn
from ggmlsharp_tpu.optim.params import OptParams as JOptParams
from ggmlsharp_tpu_torch.kernels import _build
from ggmlsharp_tpu_torch.graph import builders as B
from ggmlsharp_tpu_torch.graph import leaf, set_param
from ggmlsharp_tpu_torch.models import captured, gpt2, llama
from ggmlsharp_tpu_torch.models.common import lm_loss
from ggmlsharp_tpu_torch.optim import OptParams, opt, opt_adam, opt_fn, \
    value_and_grad
from ggmlsharp_tpu_torch.optim import adam as tadam
from ggmlsharp_tpu_torch.optim.tree import tree_leaves, tree_map
from test_torch_lbfgs_jit import _NoHostSync

class _NoHostTraffic(_NoHostSync):
    """_NoHostSync, and also refuses a tensor made from host data
    (torch.tensor / torch.as_tensor: aten.lift_fresh), which on the card is
    a host-to-device copy that a capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            raise RuntimeError(f"host copy: {func}")
        return super().__torch_dispatch__(func, types, args, kwargs)


RNG = np.random.default_rng(23)
X = RNG.standard_normal((16, 5)).astype(np.float32)
Y = RNG.standard_normal(16).astype(np.float32)
X0 = {"w1": RNG.standard_normal((5, 6)).astype(np.float32) * 0.5,
      "b1": np.zeros(6, np.float32),
      "w2": RNG.standard_normal(6).astype(np.float32) * 0.5}


def _loss(x, xp):
    """A one-hidden-layer regression: mean((tanh(X w1 + b1) w2 - Y)^2)."""
    tanh = jnp.tanh if xp is jnp else torch.tanh
    Xa, Ya = (jnp.asarray(X), jnp.asarray(Y)) if xp is jnp \
        else (torch.from_numpy(X), torch.from_numpy(Y))
    h = tanh(Xa @ x["w1"] + x["b1"])
    return xp.mean((h @ x["w2"] - Ya) ** 2)


def _params(pkg, n_iter=12, alpha=0.05, eps_f=0.0, past=0, delta=1e-5,
            max_no_improvement=0, gclip=0.0, wd=0.0):
    p = JOptParams() if pkg == "jax" else OptParams()
    p.adam.n_iter, p.adam.alpha, p.adam.eps_f = n_iter, alpha, eps_f
    p.adam.gclip, p.adam.weight_decay = gclip, wd
    p.past, p.delta, p.max_no_improvement = past, delta, max_no_improvement
    return p


def _run_both(**kw):
    """(JAX's (x, f, result, iters, losses), the port's), from X0."""
    out = {}
    for pkg in ("jax", "torch"):
        fs = []
        if pkg == "jax":
            x, f, res, it = jopt_fn(lambda x: _loss(x, jnp),
                                    {k: jnp.asarray(v) for k, v in X0.items()},
                                    _params(pkg, **kw),
                                    lambda i, fv: fs.append(fv))
            x = {k: np.asarray(v) for k, v in x.items()}
        else:
            x, f, res, it = opt_fn(lambda x: _loss(x, torch),
                                   {k: torch.from_numpy(v)
                                    for k, v in X0.items()},
                                   _params(pkg, **kw),
                                   lambda i, fv: fs.append(fv))
            x = {k: v.numpy() for k, v in x.items()}
        out[pkg] = (x, f, res.name, it, fs)
    return out["jax"], out["torch"]


@pytest.mark.parametrize("gclip,wd", [(0.0, 0.0), (0.25, 0.0), (0.0, 0.05),
                                      (0.25, 0.05)],
                         ids=["plain", "gclip", "weight_decay", "both"])
def test_opt_fn_trajectory_matches_jax(gclip, wd):
    (jx, jf, jres, jit_, jfs), (tx, tf, tres, tit, tfs) = _run_both(
        gclip=gclip, wd=wd)
    assert (tres, tit, len(tfs)) == (jres, jit_, len(jfs)) == \
        ("DID_NOT_CONVERGE", 12, 12)
    np.testing.assert_allclose(tfs, jfs, rtol=1e-5)
    np.testing.assert_allclose(tf, jf, rtol=1e-5)
    for k in X0:
        np.testing.assert_allclose(tx[k], jx[k], rtol=1e-4, atol=1e-5)
    if gclip:  # the clip is active: the unclipped first gradient is larger
        g = value_and_grad(lambda x: _loss(x, torch))(
            {k: torch.from_numpy(v) for k, v in X0.items()})[1]
        assert float(tadam._global_norm(g)) > 2 * gclip


def _rule_margin(fs, rule, p):
    """The least relative distance from its bar of the rule's statistic
    over the iterations up to the stop (the last of ``fs``): every earlier
    test passed and the last failed, each by at least that much."""
    fs = np.asarray(fs, np.float64)
    if rule == "no_improvement":  # the comparisons against the best so far
        best = np.minimum.accumulate(fs)[:-1]
        return float(np.min(np.abs(fs[1:] - best) / np.abs(best)))
    if rule == "eps_f":
        stat, bar = np.abs(np.diff(fs)) / np.abs(fs[1:]), p.adam.eps_f
    else:
        stat, bar = np.abs(fs[:-p.past] - fs[p.past:]) / p.past, p.delta
    return float(min(1 - stat[-1] / bar, np.min(stat[:-1] / bar - 1)))


@pytest.mark.parametrize("rule,kw,margin", [
    ("eps_f", dict(n_iter=200, alpha=0.05, eps_f=0.0265), 0.1),
    ("past", dict(n_iter=200, alpha=0.1, past=4, delta=0.016), 0.1),
    ("no_improvement", dict(n_iter=200, alpha=0.1, max_no_improvement=3),
     1e-3),
])
def test_stopping_rules_end_at_the_same_iteration(rule, kw, margin):
    (jx, jf, jres, jit_, jfs), (tx, tf, tres, tit, tfs) = _run_both(**kw)
    assert (tres, tit) == (jres, jit_) and tres == "OK" and tit < 200
    assert _rule_margin(tfs, rule, _params("torch", **kw)) > margin
    np.testing.assert_allclose(tfs, jfs, rtol=1e-4)
    np.testing.assert_allclose(tf, jf, rtol=1e-4)
    for k in X0:
        np.testing.assert_allclose(tx[k], jx[k], rtol=1e-4, atol=1e-5)


def _graph_fit(pkg, gclip, wd):
    """The line fit of the reference's Test2 through ggml_opt's graph
    facade: f = sum((t0 + t1 x - y)^2) / 20 over 6 steps."""
    if pkg == "jax":
        Bm, mk, sp, run = JB, lambda a: jleaf(jnp.asarray(a)), jset_param, jopt
    else:
        Bm, mk, sp, run = B, lambda a: leaf(a, device="cpu"), set_param, opt
    xi = np.arange(1, 11, dtype=np.float32)
    t0, t1 = (sp(mk(np.full(1, v, np.float32))) for v in (0.5, -0.5))
    f = Bm.div(Bm.sum(Bm.sqr(Bm.sub(Bm.add(
        Bm.mul(mk(xi), Bm.repeat(t1, (10,))), Bm.repeat(t0, (10,))),
        mk(10 * xi + 5)))), mk(np.full(1, 20.0, np.float32)))
    fs = []
    res, fx = run(f, _params(pkg, n_iter=6, alpha=0.1, gclip=gclip, wd=wd),
                  lambda i, fv: fs.append(fv))
    return res.name, fs, [float(np.asarray(t.data)[0]) for t in (t0, t1)]


@pytest.mark.parametrize("gclip,wd", [(0.0, 0.0), (2.0, 0.1)],
                         ids=["plain", "gclip_weight_decay"])
def test_opt_graph_facade_matches_jax(gclip, wd):
    jres, jfs, jt = _graph_fit("jax", gclip, wd)
    tres, tfs, tt = _graph_fit("torch", gclip, wd)
    assert tres == jres == "DID_NOT_CONVERGE" and len(tfs) == 6
    np.testing.assert_allclose(tfs, jfs, rtol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-5)


def test_x0_is_copied_and_never_written():
    """opt_adam steps its own copy of x0: the caller's tensors and numpy
    arrays keep their values, and the result shares no storage with them."""
    xt = {k: torch.from_numpy(v.copy()) for k, v in X0.items()}
    xn = {k: v.copy() for k, v in X0.items()}
    for x0 in (xt, xn):
        x, _, _, it = opt_adam(value_and_grad(lambda x: _loss(x, torch)),
                               x0, _params("torch", n_iter=3))
        assert it == 3
        for k in X0:
            assert np.array_equal(np.asarray(x0[k]), X0[k])
            assert not np.allclose(x[k].numpy(), X0[k])
            assert x[k].data_ptr() != torch.as_tensor(x0[k]).data_ptr()


def _small_model(name="gpt2"):
    """(forward, cfg, f32 params, tokens [2, 9]) of a 2-layer GPT-2 or
    Llama."""
    mod, cfg = (gpt2, gpt2.GPT2Config(n_vocab=64, n_ctx=16, n_embd=32,
                                      n_head=4, n_layer=2)) \
        if name == "gpt2" else (llama, llama.LlamaConfig(
            n_vocab=64, n_ctx=16, n_embd=32, n_head=4, n_head_kv=2,
            n_layer=2, n_ff=64))
    params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 9)).astype(np.int32))
    return mod.forward, cfg, params, toks


def _state(params):
    """opt_adam's state at its start: (x, m, v, t)."""
    return (tree_map(torch.clone, params), tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params), torch.zeros(()))


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_adam_step_of_a_model_makes_no_host_sync(name):
    """One whole in-place step of a small model's lm_loss (gclip and
    weight decay on) under the mode that refuses host reads and host
    copies, twice: t advances and x moves."""
    forward, cfg, params, toks = _small_model(name)
    vg = value_and_grad(lambda p: lm_loss(forward, cfg, p, toks))
    x, m, v, t = _state(params)
    with _NoHostTraffic():
        for _ in range(2):
            f, gn = tadam._adam_step_(vg, x, m, v, t, 1e-3, 0.9, 0.999,
                                      1e-8, 0.01, 1.0)
    assert float(t) == 2.0 and float(f) > 0 and float(gn) > 0
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(x), tree_leaves(params)))


@pytest.mark.parametrize("kind", ["sync", "copy"])
def test_a_host_sync_in_the_objective_fires_the_check(kind):
    """The control: the same step over a loss that reads a tensor back
    (float() of its sign), or that multiplies by a tensor made from host
    data, raises under the mode."""
    forward, cfg, params, toks = _small_model()

    def synced(p):
        loss = lm_loss(forward, cfg, p, toks)
        if kind == "sync":
            return loss * float(loss.detach() > 0)
        return loss * torch.tensor(1.0)

    x, m, v, t = _state(params)
    with pytest.raises(RuntimeError, match=f"host {kind}"), \
            _NoHostTraffic():
        tadam._adam_step_(value_and_grad(synced), x, m, v, t, 1e-3, 0.9,
                          0.999, 1e-8, 0.0, 0.0)


# --- the warm-first-call protocol, with torch.cuda's capture stubbed -------

class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: replay() runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda's capture calls as no-ops on the CPU (the capture context
    runs its body eagerly) and a CapturedStep device that reads as cuda."""
    class _Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(captured, "capture_stream", lambda d: _Stream())
    monkeypatch.setattr(captured.CapturedStep, "_device",
                        lambda self, g: torch.device("cuda"))


def test_warm_first_call_runs_then_captures_then_replays(stub_cuda):
    """The first call runs fn (its launches count, its update is kept and
    its result returned), the second captures (the capture's launches are
    taken back) and replays, later calls only replay; release() drops the
    graph."""
    state = torch.zeros(())
    runs = []

    def fn():
        runs.append(float(state))
        _build.check("flash_attn", 0)
        state.add_(1.0)
        return state * 2

    _build.reset_launches()
    captured.reset_counts()
    cs = captured.CapturedStep(fn, device="cpu", warm_first_call=True)
    out1 = cs()
    assert runs == [0.0] and float(out1) == 2.0
    assert _build.LAUNCHES["flash_attn"] == 1
    cs()  # the capture (run eagerly by the stub: state 2) and a replay
    cs()
    assert runs == [0.0, 1.0] and float(state) == 2.0  # never restored
    assert captured.COUNTS["captures"] == 1
    assert captured.COUNTS["replays"] == 2
    assert captured.COUNTS["warmup_s"] == 0.0
    assert _build.LAUNCHES["flash_attn"] == 3  # 1 eager + 2 replays
    (g,) = cs._graphs.values()
    assert g.graph.replays == 2
    cs.release()
    assert not cs._graphs
    _build.reset_launches()
    captured.reset_counts()


def test_one_iteration_captures_nothing(stub_cuda):
    """opt_adam with n_iter 1 runs its one step eagerly (the warm-up) and
    captures nothing; with n_iter 3 it captures once and replays twice."""
    for n_iter, caps, reps in ((1, 0, 0), (3, 1, 2)):
        captured.reset_counts()
        opt_adam(value_and_grad(lambda x: _loss(x, torch)),
                 {k: torch.from_numpy(v) for k, v in X0.items()},
                 _params("torch", n_iter=n_iter))
        assert (captured.COUNTS["captures"], captured.COUNTS["replays"]) \
            == (caps, reps)
    captured.reset_counts()
