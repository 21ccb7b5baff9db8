"""The captured training and evaluation forms on the card (needs a CUDA
device; skips without one): ``opt_adam``, ``opt_torch``, ``Graph.compute``
and the perplexity window each against its own eager form
(``captured.disabled()``), the capture counts, the caller's x0 untouched,
an optimizer that cannot be captured raising, and ``mul_mat_f``'s
tensor-core route for two bf16 operands against its f32 route. Imports no
JAX, so it runs where JAX is not installed: ``python -m pytest
--noconftest tests/test_torch_training_card.py`` (conftest imports JAX).

Bars: the same f32 (or bf16) operations run in both forms, so losses agree
to rtol 1e-5 and parameters to rtol 1e-4 / atol 1e-5 (cuBLAS may pick
another algorithm inside a capture); launches are equal key for key. The
bf16 product against the f32 route: within one bf16 ulp plus 2^-16 of
sum|a b| (both accumulate in f32, in other orders).
"""
import numpy as np
import pytest
import torch

from ggmlsharp_tpu_torch import kernels
from ggmlsharp_tpu_torch.eval import perplexity
from ggmlsharp_tpu_torch.graph import build_backward, build_forward, set_data
from ggmlsharp_tpu_torch.graph import builders as B
from ggmlsharp_tpu_torch.graph import leaf, set_f32, set_param
from ggmlsharp_tpu_torch.models import captured, gpt2
from ggmlsharp_tpu_torch.models.common import lm_loss
from ggmlsharp_tpu_torch.ops import mul_mat_f
from ggmlsharp_tpu_torch.optim import (AdamParams, GgmlAdam, OptParams,
                                       opt_adam, opt_torch, value_and_grad)
from ggmlsharp_tpu_torch.optim.tree import tree_leaves


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gpt2(dev, dtype=torch.float32):
    cfg = gpt2.GPT2Config(n_vocab=256, n_ctx=64, n_embd=128, n_head=4,
                          n_layer=2)
    params = gpt2.init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev, dtype=dtype)
    toks = torch.randint(0, 256, (4, 33), dtype=torch.int32, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    return cfg, params, toks


def _run(form, fn):
    """fn() in ``form`` ("eager" or "captured"): (its result, launches,
    captured.COUNTS)."""
    kernels.reset_launches()
    captured.reset_counts()
    if form == "eager":
        with captured.disabled():
            out = fn()
    else:
        out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), dict(captured.COUNTS)


def _params(n_iter, **adam):
    return OptParams(adam=AdamParams(n_iter=n_iter, eps_f=0.0, **adam),
                     past=0, max_no_improvement=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_opt_adam_equals_its_eager_form(dtype):
    dev = _card()
    cfg, params, toks = _gpt2(dev, dtype)
    before = [t.clone() for t in tree_leaves(params)]
    vg = value_and_grad(lambda p: lm_loss(gpt2.forward, cfg, p, toks))
    res = {}
    for form in ("eager", "captured"):
        losses = []
        res[form] = _run(form, lambda: opt_adam(
            vg, params, _params(5, gclip=1.0, weight_decay=0.01),
            lambda i, f: losses.append(f))) + (losses,)
    (xe, _, _, ie), le, ce, fe = res["eager"]
    (xc, _, _, ic), lc, cc, fc = res["captured"]
    assert ie == ic == 5 and le == lc and le["flash_attn"] == 5 * 2
    assert (ce["captures"], cc["captures"], cc["replays"]) == (0, 1, 4)
    np.testing.assert_allclose(fc, fe, rtol=1e-5)
    for a, b in zip(tree_leaves(xc), tree_leaves(xe)):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-4,
                                   atol=1e-5 if dtype == torch.float32
                                   else 1e-2)
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)  # x0 never written


@pytest.mark.cuda
def test_one_iteration_captures_nothing():
    dev = _card()
    cfg, params, toks = _gpt2(dev)
    vg = value_and_grad(lambda p: lm_loss(gpt2.forward, cfg, p, toks))
    _, launches, counts = _run("captured", lambda: opt_adam(
        vg, params, _params(1)))
    assert counts["captures"] == 0 and launches["flash_attn"] == 2


def _decoder(dev, gen):
    V, E, H, S = 96, 64, 4, 16
    ws = [set_param(leaf(torch.randn(s, generator=gen, device=dev) * 0.1))
          for s in [(V, E), (E, E), (E, E), (E, E), (E, E)]]
    tok = leaf(torch.zeros(S, dtype=torch.int32, device=dev))
    x = B.get_rows(ws[0], tok)
    hd = E // H
    heads = [B.permute(B.reshape(B.mul_mat(w, B.rms_norm(x)), (S, H, hd)),
                       (1, 0, 2)) for w in ws[1:4]]
    o = B.flash_attn(heads[0], heads[1], heads[2], masked=True)
    o = B.reshape(B.cont(B.permute(o, (1, 0, 2))), (S, E))
    logits = B.mul_mat(ws[0], B.rms_norm(B.add(x, B.mul_mat(ws[4], o))))
    f = B.sum(B.soft_max(logits))
    return tok, f, ws, V, S


@pytest.mark.cuda
def test_second_compute_after_set_data_captures_nothing():
    dev = _card()
    gen = torch.Generator(dev).manual_seed(3)
    tok, f, ws, V, S = _decoder(dev, gen)
    gf = build_forward(f)
    gb = build_backward(gf)
    toks = [torch.randint(0, V, (S,), dtype=torch.int32, device=dev,
                          generator=gen) for _ in range(2)]
    out = {}
    for form in ("eager", "captured"):
        vals = []
        for i, t in enumerate(toks):
            set_data(tok, t)
            gf.reset()
            set_f32(f.grad, 1.0)
            _, launches, counts = _run(form, gb.compute)
            vals.append((f.data.clone(), ws[1].grad.data,
                         dict(launches), dict(counts)))
        out[form] = vals
    for (fe, ge, le, _), (fc, gc, lc, cc) in zip(out["eager"],
                                                 out["captured"]):
        torch.testing.assert_close(fc, fe, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gc, ge, rtol=1e-4, atol=1e-6)
        assert lc == le and le["flash_attn_uncached"] >= 1
    assert out["captured"][0][3]["captures"] == 1
    assert out["captured"][1][3]["captures"] == 0  # the second compute
    assert out["captured"][1][3]["replays"] == 1
    # the first compute's held gradient (checked above against the eager
    # form's after the second compute ran) differs from the second's
    assert not torch.equal(out["captured"][0][1], out["captured"][1][1])


@pytest.mark.cuda
def test_opt_torch_over_an_uncapturable_optimizer_raises():
    dev = _card()
    x0 = {"w": torch.randn(8, device=dev)}
    vg = value_and_grad(lambda x: torch.sum((x["w"] - 1.0) ** 2))
    with pytest.raises(RuntimeError, match="capturable"):
        opt_torch(vg, x0, lambda ps: torch.optim.Adam(ps, lr=0.1,
                                                      capturable=False),
                  _params(4))
    res = {}
    for form in ("eager", "captured"):
        res[form] = _run(form, lambda: opt_torch(
            vg, x0, lambda ps: torch.optim.Adam(ps, lr=0.1, capturable=True),
            _params(4)))
    assert res["captured"][2]["captures"] == 1
    torch.testing.assert_close(res["captured"][0][0]["w"],
                               res["eager"][0][0]["w"], rtol=1e-6, atol=1e-7)
    (xg, _, _, _), _, counts = _run("captured", lambda: opt_torch(
        vg, x0, lambda ps: GgmlAdam(ps, AdamParams(alpha=0.1)), _params(4)))
    (xa, _, _, _), _, _ = _run("captured", lambda: opt_adam(
        vg, x0, _params(4, alpha=0.1)))
    assert counts["captures"] == 1 and torch.equal(xg["w"], xa["w"])


@pytest.mark.cuda
def test_perplexity_captured_equals_its_eager_form():
    dev = _card()
    cfg, params, _ = _gpt2(dev)
    stream = np.random.default_rng(4).integers(0, 256, 200).astype(np.int32)
    e, le, _ = _run("eager", lambda: perplexity(gpt2.forward, cfg, params,
                                                stream, chunk_len=48))
    c, lc, cc = _run("captured", lambda: perplexity(gpt2.forward, cfg,
                                                    params, stream,
                                                    chunk_len=48))
    assert c[2] == e[2] and lc == le and le["flash_attn"] == 2 * 4
    assert (cc["captures"], cc["replays"]) == (1, 4)
    np.testing.assert_allclose(c[1], e[1], rtol=1e-6)


@pytest.mark.cuda
def test_bf16_product_on_the_tensor_cores_matches_the_f32_route():
    dev = _card()
    gen = torch.Generator(dev).manual_seed(5)
    a = (torch.randn(384, 256, generator=gen, device=dev) * 0.2).bfloat16()
    b = torch.randn(2, 40, 256, generator=gen, device=dev).bfloat16()
    a.requires_grad_()
    b.requires_grad_()
    y = mul_mat_f(a, b)
    a32 = a.detach().float().requires_grad_()
    b32 = b.detach().float().requires_grad_()
    y32 = torch.matmul(b32, a32.t())
    g = torch.randn(y.shape, generator=gen, device=dev).bfloat16()
    y.backward(g)
    y32.backward(g.float())
    allow = 2.0 ** -16 * (b32.detach().abs() @ a32.detach().abs().t())
    err = (y.float() - y32.detach()).abs()
    assert y.dtype == torch.bfloat16
    assert bool((err <= 2.0 ** -7 * y32.detach().abs() + allow).all())
    for got, want in ((a.grad, a32.grad), (b.grad, b32.grad)):
        assert got.dtype == torch.bfloat16
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= 2.0 ** -8, rel
