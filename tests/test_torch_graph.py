"""The port's graph layer against the JAX package's, on the CPU: Test0's
tensor creation, the reference's Test1 autodiff cases 1-8 (with the
Hessian-vector products of backward-of-backward), the VJPs the reference
lacks, the generic VJP through soft_max, the attention op chain and a
flash-attention decoder built as examples/graph_transformer.py builds it.

Each case is one function that builds its graph through a namespace of
graph functions; it runs once with the JAX package's and once with the
port's, and the values and gradients of the two are compared (and, for
Test1, both against the reference's closed forms).

Tolerances: Test1's closed forms are small integers, exact in f32 in both
packages. Float graphs differ in f32 summation order and libm ulps: rtol
1e-5 / atol 1e-6 on values of magnitude ~1 (measured ~1e-7), 1e-4 relative
on the decoder's gradients, which chain two layers of products.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import graph as jgraph
from ggmlsharp_tpu_torch import graph as tgraph


def _ns(pkg):
    """The graph functions of one package, leaves made from numpy."""
    if pkg == "jax":
        g, mk = jgraph, lambda a: jgraph.leaf(jnp.asarray(a))
        out = lambda t: np.asarray(t.data, np.float32)
    else:
        g, mk = tgraph, lambda a: tgraph.leaf(a, device="cpu")
        out = lambda t: t.data.to(torch.float32).numpy()
    return types.SimpleNamespace(
        B=g.builders, mk=mk, set_param=g.set_param, fwd=g.build_forward,
        bwd=g.build_backward, set_f32=g.set_f32, get=g.get_f32_1d, out=out,
        set_data=g.set_data)


def _scalar(G, v=0.0):
    return G.mk(np.full((1,), v, np.float32))


def _vec3(G, v=0.0):
    return G.mk(np.full((3,), v, np.float32))


def _backward(G, y, gf=None, keep=False):
    gf = gf or G.fwd(y)
    gb = G.bwd(gf, keep=keep)
    gf.reset()
    G.set_f32(y.grad, 1.0)
    gb.compute()
    return gf, gb


# --- Test0 ----------------------------------------------------------------------

def test0_leaf_shapes_and_dtypes():
    """Leaves keep the shapes and dtypes given (ggml ne order reversed),
    and numpy input lands as the JAX package makes it (f64 -> f32,
    i64 -> i32)."""
    for shape, dt in (((10,), np.float32), ((20, 10), np.float32),
                      ((30, 20, 10), np.int16), ((2, 3), np.float64),
                      ((4,), np.int64)):
        a = np.zeros(shape, dt)
        j, t = _ns("jax").mk(a), _ns("torch").mk(a)
        assert j.shape == t.shape == shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)


# --- Test1, cases 1-8 -----------------------------------------------------------

def _case1(G):
    # f = a*x^2, df/dx = 2ax; then the same graphs on new data
    x, a = G.set_param(_scalar(G)), _scalar(G)
    f = G.B.mul(G.B.mul(x, x), a)
    gf = G.fwd(f)
    gb = G.bwd(gf, keep=False)
    res = []
    for xv, av in ((2.0, 3.0), (3.0, 3.0)):
        G.set_f32(x, xv)
        G.set_f32(a, av)
        gf.reset()
        G.set_f32(f.grad, 1.0)
        gb.compute()
        res += [G.get(f, 0), G.get(x.grad, 0)]
    return res, [12.0, 12.0, 27.0, 18.0]


def _case2(G):
    # y = x1^2 + x1*x2: grads (2x1+x2, x1); H·[1,1] = [3, 1]
    x1, x2 = G.set_param(_scalar(G, 3.0)), G.set_param(_scalar(G, 1.0))
    y = G.B.add(G.B.mul(x1, x1), G.B.mul(x1, x2))
    _, gb = _backward(G, y)
    res = [G.get(y, 0), G.get(x1.grad, 0), G.get(x2.grad, 0)]
    g1, g2 = x1.grad, x2.grad
    gbb = G.bwd(gb, keep=True)
    gb.reset()
    G.set_f32(g1.grad, 1.0)
    G.set_f32(g2.grad, 1.0)
    gbb.compute()
    return res + [G.get(x1.grad, 0), G.get(x2.grad, 0)], \
        [12.0, 7.0, 3.0, 3.0, 1.0]


def _case3(G):
    # y = (x1^2 + x1*x2) * x1 at (3, 4)
    x1, x2 = G.set_param(_scalar(G)), G.set_param(_scalar(G))
    y = G.B.mul(G.B.add(G.B.mul(x1, x1), G.B.mul(x1, x2)), x1)
    G.set_f32(x1, 3.0)
    G.set_f32(x2, 4.0)
    _backward(G, y)
    return [G.get(y, 0), G.get(x1.grad, 0), G.get(x2.grad, 0)], \
        [63.0, 51.0, 9.0]


def _case4(G):
    # y = x1^2 * x2^2 * x3 at (1, 2, 3); H·[1,1,1] = (56, 34, 12)
    xs = [G.set_param(_scalar(G)) for _ in range(3)]
    x1, x2, x3 = xs
    y = G.B.mul(G.B.mul(G.B.mul(x1, x1), G.B.mul(x2, x2)), x3)
    for x, v in zip(xs, (1.0, 2.0, 3.0)):
        G.set_f32(x, v)
    _, gb = _backward(G, y)
    res = [G.get(y, 0)] + [G.get(x.grad, 0) for x in xs]
    gs = [x.grad for x in xs]
    gbb = G.bwd(gb, keep=True)
    gb.reset()
    for g in gs:
        G.set_f32(g.grad, 1.0)
    gbb.compute()
    return res + [G.get(x.grad, 0) for x in xs], \
        [12.0, 24.0, 12.0, 4.0, 56.0, 34.0, 12.0]


def _vec_pair(G):
    x1, x2 = G.set_param(_vec3(G)), G.set_param(_vec3(G))
    return x1, x2


def _vec_grads(G, y, x1, x2):
    return [G.get(y, 0)] + [G.get(x.grad, i) for x in (x1, x2)
                            for i in range(3)]


def _case5(G):
    # y = sum(x1*x2) at (3, 5)
    x1, x2 = _vec_pair(G)
    y = G.B.sum(G.B.mul(x1, x2))
    G.set_f32(x1, 3.0)
    G.set_f32(x2, 5.0)
    _backward(G, y)
    return _vec_grads(G, y, x1, x2), [45.0] + [5.0] * 3 + [3.0] * 3


def _case6(G):
    # y = sum(x1*x2 + repeat(-2)*x1^2) at (3, 5)
    x1, x2 = _vec_pair(G)
    c = G.mk(np.full((1,), -2.0, np.float32))
    y = G.B.sum(G.B.add(G.B.mul(x1, x2),
                        G.B.mul(G.B.repeat(c, (3,)), G.B.mul(x1, x1))))
    G.set_f32(x1, 3.0)
    G.set_f32(x2, 5.0)
    _backward(G, y)
    return _vec_grads(G, y, x1, x2), [-9.0] + [-7.0] * 3 + [3.0] * 3


def _case7(G):
    # y = sum(x1*x2 - x1^2*repeat(-2)) at (3, 5)
    x1, x2 = _vec_pair(G)
    c = G.mk(np.full((1,), -2.0, np.float32))
    y = G.B.sum(G.B.sub(G.B.mul(x1, x2),
                        G.B.mul(G.B.mul(x1, x1), G.B.repeat(c, (3,)))))
    G.set_f32(x1, 3.0)
    G.set_f32(x2, 5.0)
    _backward(G, y)
    return _vec_grads(G, y, x1, x2), [99.0] + [17.0] * 3 + [3.0] * 3


def _case8(G):
    # y = sum(abs(x1 - x2)): the sign flips with the operand order
    x1, x2 = _vec_pair(G)
    y = G.B.sum(G.B.abs_(G.B.sub(x1, x2)))
    gf = G.fwd(y)
    gb = G.bwd(gf, keep=False)
    res = []
    for v1 in (3.0, 7.0):
        G.set_f32(x1, v1)
        G.set_f32(x2, 5.0)
        gf.reset()
        G.set_f32(y.grad, 1.0)
        gb.compute()
        res += _vec_grads(G, y, x1, x2)
    return res, ([6.0] + [-1.0] * 3 + [1.0] * 3 + [6.0] + [1.0] * 3
                 + [-1.0] * 3)


@pytest.mark.parametrize("case", [_case1, _case2, _case3, _case4, _case5,
                                  _case6, _case7, _case8],
                         ids=[f"case{i}" for i in range(1, 9)])
def test1_autodiff_cases(case):
    got, closed = case(_ns("torch"))
    want, _ = case(_ns("jax"))
    assert got == want == closed


# --- beyond the reference ---------------------------------------------------------

def _coverage(G, xv, wv):
    x, w = G.set_param(G.mk(xv)), G.set_param(G.mk(wv))
    h = G.B.mul_mat(w, G.B.rms_norm(G.B.gelu(x)))
    y = G.B.sum(G.B.mul(G.B.scale_const(G.B.transpose(h), 0.5),
                        G.B.transpose(G.B.mean(G.B.repeat(h, (4, 5))))))
    _backward(G, y)
    return [G.out(t) for t in (y, x.grad, w.grad)]


def _softmax_chain(G, xv, _):
    x = G.set_param(G.mk(xv))
    y = G.B.sum(G.B.sqr(G.B.soft_max(x)))
    _, gb = _backward(G, y)
    res = [G.out(y), G.out(x.grad)]
    gx = x.grad
    gbb = G.bwd(gb, keep=True)  # a generic VJP differentiated again
    gb.reset()
    G.set_f32(gx.grad, 1.0)
    gbb.compute()
    return res + [G.out(x.grad)]


def _attention_chain(G, xv, wv):
    wq, x = G.set_param(G.mk(wv)), G.mk(xv)
    q = G.B.mul_mat(wq, x)
    att = G.B.soft_max(G.B.diag_mask_inf(
        G.B.scale_const(G.B.mul_mat(x, q), 0.25), 0))
    o = G.B.mul_mat(G.B.cont(G.B.transpose(x)), att)
    f = G.B.sum(G.B.mul(o, o))
    _backward(G, f)
    return [G.out(f), G.out(wq.grad)]


@pytest.mark.parametrize("case,shapes", [
    (_coverage, ((4, 8), (5, 8))),          # gelu, rms_norm, mul_mat, scale,
    (_softmax_chain, ((3, 6), (1,))),       # transpose, mean, repeat VJPs
    (_attention_chain, ((4, 8), (8, 8))),
], ids=["full_coverage_vjps", "generic_vjp_softmax", "attention_chain"])
def test_graph_values_and_grads_match_jax(case, shapes):
    rng = np.random.default_rng(len(shapes[0]) * 7 + shapes[1][0])
    xv, wv = (rng.standard_normal(s).astype(np.float32) * 0.5 for s in shapes)
    got = case(_ns("torch"), xv, wv)
    want = case(_ns("jax"), xv, wv)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def decoder(G, weights, S, H, masked_flash=True):
    """The decoder of examples/graph_transformer.py, with B.flash_attn in
    place of its mul_mat / diag_mask_inf / soft_max chain; weights: numpy
    arrays (wte [V, E], then per layer wq, wk, wv, wo [E, E], w_up [4E, E],
    w_down [E, 4E]). Returns (tokens leaf, logits node, param leaves)."""
    B = G.B
    tok = G.mk(np.zeros((S,), np.int32))
    ws = [G.set_param(G.mk(w)) for w in weights]
    it = iter(ws)
    wte = next(it)
    E = weights[0].shape[1]
    hd = E // H
    x = B.get_rows(wte, tok)
    for _ in range((len(weights) - 1) // 6):
        wq, wk, wv, wo, w_up, w_down = (next(it) for _ in range(6))
        h = B.rms_norm(x)
        heads = [B.permute(B.reshape(B.mul_mat(w, h), (S, H, hd)), (1, 0, 2))
                 for w in (wq, wk, wv)]
        q, k = B.rope(heads[0], 0), B.rope(heads[1], 0)
        o = B.flash_attn(q, k, heads[2], masked=masked_flash)  # [H, S, hd]
        o = B.reshape(B.cont(B.permute(o, (1, 0, 2))), (S, E))
        x = B.add(x, B.mul_mat(wo, o))
        x = B.add(x, B.mul_mat(w_down, B.gelu(B.mul_mat(w_up, B.rms_norm(x)))))
    return tok, B.mul_mat(wte, B.rms_norm(x)), ws


def test_flash_decoder_values_and_grads_match_jax():
    """Path h's graph decoder at a small size (V 48, E 32, 4 heads of D 8,
    S 12, 2 layers): logits and every weight's gradient of
    sum(soft_max(logits) * onehot) against the JAX graph (flash_attn takes
    the materialised-scores route on the CPU in both packages)."""
    rng = np.random.default_rng(9)
    V, E, S, H = 48, 32, 12, 4
    shapes = [(V, E)] + [(E, E)] * 4 + [(4 * E, E), (E, 4 * E)]
    weights = [rng.standard_normal(s).astype(np.float32) * 0.1
               for s in shapes + shapes[1:]]
    toks = rng.integers(0, V, S).astype(np.int32)
    onehot = np.eye(V, dtype=np.float32)[rng.integers(0, V, S)]
    res = {}
    for pkg in ("torch", "jax"):
        G = _ns(pkg)
        tok, logits, ws = decoder(G, weights, S, H)
        G.set_data(tok, toks if pkg == "torch" else jnp.asarray(toks))
        f = G.B.sum(G.B.mul(G.B.soft_max(logits), G.mk(onehot)))
        _backward(G, f)
        res[pkg] = [G.out(logits), G.out(f)] + [G.out(w.grad) for w in ws]
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max() + 1e-7)


def test_builder_shape_error_raises_at_build_time():
    """A mismatched mul_mat fails at the builder with the op name and the
    operand shapes (meta-device shape inference)."""
    G = _ns("torch")
    with pytest.raises(ValueError, match=r"mul_mat.*\(4, 5\)"):
        G.B.mul_mat(G.mk(np.zeros((4, 5), np.float32)),
                    G.mk(np.zeros((3, 7), np.float32)))
