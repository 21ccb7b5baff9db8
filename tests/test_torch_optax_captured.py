"""``opt_torch`` over ``GgmlAdam`` in its captured form (optim/
optax_compat.py: the gradients written into fixed ``leaf.grad`` buffers,
GgmlAdam's step count a device tensor and its moments written in place, so
that the card captures value, gradient and ``opt.step()`` into one graph)
against the JAX package's jitted ``opt_optax`` over ``as_optax``, on the
CPU, where the same step runs eagerly.

Bars as in test_torch_adam_captured.py (the same objective and stopping
cases): losses to rtol 1e-5 over 12 steps and 1e-4 over the stopping runs,
the end point to rtol 1e-4 / atol 1e-5, the same result and iteration.
GgmlAdam's step (on gradients already computed) runs under the dispatch
mode that refuses every read back to the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.optim import as_optax, opt_optax
from ggmlsharp_tpu.optim.params import AdamParams as JAdamParams
from ggmlsharp_tpu_torch.optim import AdamParams, GgmlAdam, opt_torch, \
    value_and_grad
from test_torch_adam_captured import (X0, _loss, _NoHostTraffic, _params,
                                      _rule_margin)


def _adam_kw(kw):
    return dict(alpha=kw.get("alpha", 0.05), gclip=kw.get("gclip", 0.0),
                weight_decay=kw.get("wd", 0.0))


def _run_both(**kw):
    """(JAX's (x, f, result, iters, losses), the port's), from X0."""
    jfs, tfs = [], []
    jx, jf, jres, jit_ = opt_optax(
        jax.value_and_grad(lambda x: _loss(x, jnp)),
        {k: jnp.asarray(v) for k, v in X0.items()},
        as_optax(JAdamParams(**_adam_kw(kw))), _params("jax", **kw),
        lambda i, f: jfs.append(f))
    tx, tf, tres, tit = opt_torch(
        value_and_grad(lambda x: _loss(x, torch)),
        {k: torch.from_numpy(v) for k, v in X0.items()},
        lambda ps: GgmlAdam(ps, AdamParams(**_adam_kw(kw))),
        _params("torch", **kw), lambda i, f: tfs.append(f))
    return ((jx, jf, jres.name, jit_, jfs),
            ({k: v.numpy() for k, v in tx.items()}, tf, tres.name, tit, tfs))


def _close(j, t, rtol):
    (jx, jf, jres, jit_, jfs), (tx, tf, tres, tit, tfs) = j, t
    assert (tres, tit, len(tfs)) == (jres, jit_, len(jfs))
    np.testing.assert_allclose(tfs, jfs, rtol=rtol)
    np.testing.assert_allclose(tf, jf, rtol=rtol)
    for k in X0:
        np.testing.assert_allclose(tx[k], np.asarray(jx[k]), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("gclip,wd", [(0.0, 0.0), (0.25, 0.05)],
                         ids=["plain", "gclip_weight_decay"])
def test_opt_torch_ggml_adam_matches_opt_optax(gclip, wd):
    j, t = _run_both(gclip=gclip, wd=wd)
    _close(j, t, 1e-5)
    assert t[2] == "DID_NOT_CONVERGE" and t[3] == 12


@pytest.mark.parametrize("rule,kw,margin", [
    ("eps_f", dict(n_iter=200, alpha=0.05, eps_f=0.0265), 0.1),
    ("no_improvement", dict(n_iter=200, alpha=0.1, max_no_improvement=3),
     1e-3),
])
def test_opt_torch_stops_where_opt_optax_stops(rule, kw, margin):
    j, t = _run_both(**kw)
    _close(j, t, 1e-4)
    assert t[2] == "OK" and t[3] < 200
    assert _rule_margin(t[4], rule, _params("torch", **kw)) > margin


def test_ggml_adam_step_makes_no_host_sync():
    """Two GgmlAdam steps (the first makes the moments and the count) with
    the clip and the decay on, under the no-host-sync mode."""
    ps = [torch.from_numpy(X0[k]).clone() for k in sorted(X0)]
    opt = GgmlAdam(ps, AdamParams(alpha=0.05, gclip=0.25, weight_decay=0.05))
    g = value_and_grad(lambda x: _loss(x, torch))(dict(zip(sorted(X0), ps)))[1]
    for p, k in zip(ps, sorted(X0)):
        p.grad = g[k].clone()
    with _NoHostTraffic():
        opt.step()
        opt.step()
    assert float(opt._count) == 2.0
    assert not torch.equal(ps[0], torch.from_numpy(X0[sorted(X0)[0]]))
