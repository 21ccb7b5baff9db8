"""The port's torch.optim interop (optim.optax_compat) against the JAX
package's optax interop (ggmlsharp_tpu/optim/optax_compat.py,
tests/test_optim.py:218-300).

  * GgmlAdam, the port's Adam as a torch.optim.Optimizer, follows the
    port's own _adam_step bit for bit (the same f32 operations in the same
    order), and JAX's as_optax within its own test's tolerance (rtol 3e-5,
    atol 3e-6: XLA's f32 rounding of the same math differs in the last
    ulps);
  * opt_torch, ggml's stopping rules over any torch.optim.Optimizer, with
    torch.optim.SGD against JAX's opt_optax with optax.sgd: the same
    losses at every iteration (rtol 1e-5: f32 sums in other orders), the
    same final iterate (rtol 1e-5, atol 1e-6), OptResult and n_iters under
    each of the three rules (relative Δf, the past window, no-improvement
    patience); each case stops where its test is far from its bar, so an
    ulp cannot move the iteration it stops at.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggmlsharp_tpu.optim import as_optax, opt_optax
from ggmlsharp_tpu.optim.params import AdamParams as JAdamParams
from ggmlsharp_tpu.optim.params import OptParams as JOptParams
from ggmlsharp_tpu_torch.optim import (AdamParams, GgmlAdam, OptParams,
                                       OptResult, opt_adam, opt_torch,
                                       value_and_grad)
from ggmlsharp_tpu_torch.optim.adam import _adam_step

ADAM = dict(alpha=0.05, weight_decay=0.01, gclip=1.0)


def _t_loss(x):
    return torch.sum((x["w"] - 3.0) ** 2) + torch.sum(torch.abs(x["b"]))


def _j_loss(x):
    return jnp.sum((x["w"] - 3.0) ** 2) + jnp.sum(jnp.abs(x["b"]))


def _x0():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal(4).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def test_ggml_adam_follows_adam_step_and_as_optax():
    a = AdamParams(**ADAM)
    x0 = _x0()
    fun_vg = value_and_grad(_t_loss)
    # the port's own step
    x1 = {k: torch.from_numpy(v) for k, v in x0.items()}
    m = {k: torch.zeros_like(v) for k, v in x1.items()}
    v = {k: torch.zeros_like(t) for k, t in x1.items()}
    # the optimizer, over leaves in the tree's (sorted-key) order
    ps = [torch.from_numpy(x0[k]).clone().requires_grad_() for k in ("b", "w")]
    opt = GgmlAdam(ps, a)
    # JAX's optax transformation
    tx = as_optax(JAdamParams(**ADAM))
    xj = {k: jnp.asarray(v) for k, v in x0.items()}
    st = tx.init(xj)
    for t in range(1, 8):
        x1, m, v, _, _ = _adam_step(fun_vg, x1, m, v, float(t), a.alpha,
                                    a.beta1, a.beta2, a.eps, a.weight_decay,
                                    a.gclip)
        opt.zero_grad()
        _t_loss({"b": ps[0], "w": ps[1]}).backward()
        opt.step()
        upd, st = tx.update(jax.grad(_j_loss)(xj), st, xj)
        xj = optax.apply_updates(xj, upd)
    for k, p in zip(("b", "w"), ps):
        assert torch.equal(p.detach(), x1[k]), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(xj[k]),
                                   rtol=3e-5, atol=3e-6)


def test_opt_torch_with_ggml_adam_equals_opt_adam():
    """opt_torch over GgmlAdam takes opt_adam's iterates (no stopping
    rule on: n_iter steps)."""
    a = AdamParams(n_iter=12, eps_f=0.0, **ADAM)
    p = OptParams(adam=a, past=0, max_no_improvement=0)
    x0 = {k: torch.from_numpy(v) for k, v in _x0().items()}
    fun_vg = value_and_grad(_t_loss)
    losses_a, losses_t = [], []
    xa, fa, ra, ia = opt_adam(fun_vg, x0, p,
                              lambda it, f: losses_a.append(f))
    xt, ft, rt, it = opt_torch(fun_vg, x0, lambda ps: GgmlAdam(ps, a), p,
                               lambda it, f: losses_t.append(f))
    assert losses_a == losses_t and ra == rt == OptResult.DID_NOT_CONVERGE
    assert ia == it == 12
    for k in x0:
        assert torch.equal(xa[k], xt[k])
    assert ft == float(_t_loss(xt))


def test_update_refuses_weight_decay_without_params():
    ps = [torch.zeros(3, requires_grad=True)]
    with pytest.raises(ValueError, match="weight_decay needs params"):
        GgmlAdam(ps, AdamParams(weight_decay=0.01)).update([torch.ones(3)])
    tx = as_optax(JAdamParams(weight_decay=0.01))
    with pytest.raises(ValueError, match="weight_decay needs params"):
        tx.update(jnp.ones(3), tx.init(jnp.zeros(3)))
    # without weight decay params are not needed, and update does not
    # move the parameters
    u = GgmlAdam(ps, AdamParams()).update([torch.ones(3)])
    assert torch.equal(ps[0].detach(), torch.zeros(3)) and u[0].shape == (3,)


XS = np.linspace(-1, 1, 32, dtype=np.float32)
# a line and a residual the line cannot fit: f tends to a floor above 0,
# so the relative Δf falls to every eps_f bar and stops there
YS = (5.0 * XS + 10.0 + np.sin(7.0 * XS)).astype(np.float32)

# (rule, lr, n_iter, eps_f, past, delta, max_no_improvement): lr 0.1
# converges (Δf shrinks by ~0.8 a step); lr 1.2 diverges (f grows)
RULES = {
    "eps_f": (0.1, 200, 9.5e-3, 0, 1e-5, 0),
    "past": (0.1, 200, 0.0, 3, 0.45, 0),
    "no_improvement": (1.2, 200, 0.0, 0, 1e-5, 3),
    "n_iter": (0.1, 7, 0.0, 0, 1e-5, 0),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_opt_torch_sgd_matches_opt_optax_sgd(rule):
    lr, n_iter, eps_f, past, delta, patience = RULES[rule]

    def j_vg(p):
        loss = lambda p: jnp.mean((p["t0"] * XS + p["t1"] - YS) ** 2)
        return loss(p), jax.grad(loss)(p)

    xs, ys = torch.from_numpy(XS), torch.from_numpy(YS)
    t_vg = value_and_grad(
        lambda p: torch.mean((p["t0"] * xs + p["t1"] - ys) ** 2))
    jp = JOptParams(past=past, delta=delta, max_no_improvement=patience)
    jp.adam.n_iter, jp.adam.eps_f = n_iter, eps_f
    tp = OptParams(past=past, delta=delta, max_no_improvement=patience)
    tp.adam.n_iter, tp.adam.eps_f = n_iter, eps_f
    jl, tl = [], []
    xj, fj, rj, ij = opt_optax(j_vg, {"t0": jnp.zeros(()), "t1": jnp.zeros(())},
                               optax.sgd(lr), jp,
                               lambda it, f: jl.append(f))
    xt, ft, rt, it = opt_torch(t_vg, {"t0": torch.zeros(()),
                                      "t1": torch.zeros(())},
                               lambda ps: torch.optim.SGD(ps, lr=lr), tp,
                               lambda it, f: tl.append(f))
    assert (rt.name, it) == (rj.name, ij)
    if rule == "n_iter":
        assert rt == OptResult.DID_NOT_CONVERGE and it == n_iter
    else:
        assert rt == OptResult.OK and it < n_iter
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in ("t0", "t1"):
        np.testing.assert_allclose(float(xt[k]), float(xj[k]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(ft, fj, rtol=1e-5)
