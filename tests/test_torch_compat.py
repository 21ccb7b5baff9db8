"""The port's ggml-named API (compat.py) against the JAX package's: Test0's
shapes, a Test1 and a Test2 case verbatim through the ggml_* surface, the
shape predicates and accessors, the format registry, and a transformer
decoder built through the graph API (examples/graph_transformer.py's graph)
decoding the JAX package's tokens. Contexts name the CPU (``ggml_init``
defaults to the card).

Tolerances: Test1 and the predicates are exact; Test2's fit to 1e-3, the
reference's criterion, in both packages; the decoder's logits to 1e-5
(f32 summation order) and its greedy tokens exactly."""
import types

import jax.numpy as jnp
import numpy as np

from ggmlsharp_tpu import compat as J
from ggmlsharp_tpu import graph as jgraph
from ggmlsharp_tpu_torch import compat as T
from ggmlsharp_tpu_torch import graph as tgraph
from ggmlsharp_tpu_torch.dtypes import GType


def _ctx(api):
    return api.ggml_init(device="cpu") if api is T else api.ggml_init()


def test0_shape_parity():
    for api in (J, T):
        ctx = _ctx(api)
        assert api.ggml_new_tensor_1d(ctx, GType.F32, 10).shape == (10,)
        # ne0 is the fastest (last) axis
        assert api.ggml_new_tensor_2d(ctx, GType.F32, 10, 20).shape == (20, 10)
        t3 = api.ggml_new_tensor_3d(ctx, GType.I16, 10, 20, 30)
        assert t3.shape == (30, 20, 10)
        assert str(t3.dtype).split(".")[-1] == "int16"
        assert api.ggml_new_tensor_4d(ctx, GType.F16, 1, 2, 3, 4).shape == \
            (4, 3, 2, 1)
        api.ggml_free(ctx)


def test1_case1_via_compat():
    got = []
    for api in (J, T):
        ctx = _ctx(api)
        x = api.ggml_new_tensor_1d(ctx, GType.F32, 1)
        api.ggml_set_param(ctx, x)
        a = api.ggml_new_tensor_1d(ctx, GType.F32, 1)
        f = api.ggml_mul(ctx, api.ggml_mul(ctx, x, x), a)
        gf = api.ggml_build_forward(f)
        gb = api.ggml_build_backward(ctx, gf, False)
        api.ggml_set_f32(x, 2.0)
        api.ggml_set_f32(a, 3.0)
        api.ggml_graph_reset(gf)
        api.ggml_set_f32(f.grad, 1.0)
        api.ggml_graph_compute(ctx, gb)
        got.append((api.ggml_get_f32_1d(f, 0), api.ggml_get_f32_1d(x.grad, 0)))
    assert got[0] == got[1] == (12.0, 12.0)


def test2_line_fit_via_compat():
    xi = [1.0, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    yi = [15.0, 25, 35, 45, 55, 65, 75, 85, 95, 105]
    n = len(xi)
    for api, set_data in ((J, jgraph.set_data), (T, tgraph.set_data)):
        ctx = _ctx(api)
        x = set_data(api.ggml_new_tensor_1d(ctx, GType.F32, n), np.array(xi))
        y = set_data(api.ggml_new_tensor_1d(ctx, GType.F32, n), np.array(yi))
        t0, t1 = api.ggml_new_f32(ctx, 0.0), api.ggml_new_f32(ctx, 0.0)
        api.ggml_set_param(ctx, t0)
        api.ggml_set_param(ctx, t1)
        f = api.ggml_div(ctx, api.ggml_sum(ctx, api.ggml_sqr(ctx, api.ggml_sub(
            ctx, api.ggml_add(ctx, api.ggml_mul(ctx, x, api.ggml_repeat(
                ctx, t1, x)), api.ggml_repeat(ctx, t0, x)), y))),
            api.ggml_new_f32(ctx, 2.0 * n))
        params = api.ggml_opt_default_params(api.GGML_OPT_ADAM)
        params.adam.alpha = 0.01
        res = api.ggml_opt(ctx, params, f)
        assert res.name == "OK"
        assert abs(api.ggml_get_f32_1d(t0, 0) - 5.0) < 1e-3
        assert abs(api.ggml_get_f32_1d(t1, 0) - 10.0) < 1e-3


def test_predicates_and_accessors():
    for api in (J, T):
        ctx = _ctx(api)
        t = api.ggml_new_tensor_2d(ctx, GType.F32, 10, 4)  # shape (4, 10)
        assert api.ggml_nelements(t) == 40 and api.ggml_nrows(t) == 4
        assert api.ggml_nbytes(t) == 160
        assert not api.ggml_is_scalar(t) and api.ggml_is_matrix(t)
        s = api.ggml_new_f32(ctx, 3.0)
        assert api.ggml_is_scalar(s) and api.ggml_is_vector(s)
        t2 = api.ggml_new_tensor_2d(ctx, GType.F32, 10, 7)
        assert api.ggml_can_mul_mat(t, t2)
        assert not api.ggml_are_same_shape(t, t2)
        assert api.ggml_dup_tensor(ctx, t).shape == t.shape
        assert not api.ggml_is_quantized(t)
        api.ggml_set_f32_1d(t, 3, 9.0)
        assert api.ggml_get_f32_1d(t, 3) == 9.0
        i = api.ggml_set_i32(api.ggml_new_i32(ctx, 0), 7)
        assert api.ggml_get_i32_1d(i, 0) == 7


def test_quant_registry_complete():
    from ggmlsharp_tpu_torch.quant.registry import registry

    reg = registry()
    assert reg[GType.Q4_0].has_fused_matmul and reg[GType.Q4_0].has_int_dot
    assert reg[GType.Q4_3].quantize_row is not None
    assert reg[GType.Q8_1].dequantize_row is not None
    assert reg[GType.Q4_K].vec_dot_type == GType.Q8_K


def _example_graph(api, ctx, weights, S, H):
    """examples/graph_transformer.py's decoder (get_rows, rms_norm, rope,
    mul_mat / scale / diag_mask_inf / soft_max attention, GELU MLP, tied
    head) through the ggml_* names, from numpy weights."""
    B = types.SimpleNamespace(**{n[5:]: getattr(api, n) for n in dir(api)
                                 if n.startswith("ggml_")})
    mk = (lambda a: jgraph.leaf(jnp.asarray(a))) if api is J \
        else (lambda a: tgraph.leaf(a, device="cpu"))
    it = iter(mk(w) for w in weights)
    tok = mk(np.zeros((S,), np.int32))
    wte = next(it)
    E = weights[0].shape[1]
    hd = E // H
    x = B.get_rows(ctx, wte, tok)
    for _ in range((len(weights) - 1) // 6):
        wq, wk, wv, wo, w_up, w_down = (next(it) for _ in range(6))
        h = B.rms_norm(ctx, x)
        q, k, v = (B.permute(ctx, B.reshape(ctx, B.mul_mat(ctx, w, h),
                                            (S, H, hd)), (1, 0, 2))
                   for w in (wq, wk, wv))
        q, k = B.rope(ctx, q, 0), B.rope(ctx, k, 0)
        att = B.soft_max(ctx, B.diag_mask_inf(ctx, B.scale(
            ctx, B.mul_mat(ctx, k, q), mk(np.full(1, hd ** -0.5,
                                                  np.float32))), 0))
        o = B.mul_mat(ctx, B.cont(ctx, B.transpose(ctx, v)), att)
        o = B.reshape(ctx, B.cont(ctx, B.permute(ctx, o, (1, 0, 2))), (S, E))
        x = B.add(ctx, x, B.mul_mat(ctx, wo, o))
        x = B.add(ctx, x, B.mul_mat(ctx, w_down, B.gelu(
            ctx, B.mul_mat(ctx, w_up, B.rms_norm(ctx, x)))))
    logits = B.mul_mat(ctx, wte, B.rms_norm(ctx, x))
    return tok, api.ggml_build_forward(logits), logits


def test_graph_api_transformer_decodes():
    """Build once, re-set the token leaf, recompute: greedy decode of 4
    tokens from a 3-token prompt; the port's tokens are the JAX package's,
    its logits within 1e-5."""
    rng = np.random.default_rng(0)
    V, E, S, H = 96, 32, 16, 4
    shapes = [(V, E)] + [(E, E)] * 4 + [(4 * E, E), (E, 4 * E)]
    weights = [rng.standard_normal(s).astype(np.float32) * 0.08
               for s in shapes + shapes[1:]]
    runs = {}
    for api, set_data, out in (
            (J, jgraph.set_data, np.asarray),
            (T, tgraph.set_data, lambda t: t.numpy())):
        ctx = _ctx(api)
        tok, graph, logits = _example_graph(api, ctx, weights, S, H)
        toks, rows = [5, 17, 33], []
        for _ in range(4):
            padded = np.zeros((S,), np.int32)
            padded[:len(toks)] = toks
            set_data(tok, padded)
            api.ggml_graph_compute(ctx, graph)
            row = out(logits.data)[len(toks) - 1]
            assert np.isfinite(row).all()
            rows.append(row)
            toks.append(int(row.argmax()))
        runs[api.__name__] = (toks[3:], np.stack(rows))
    (jt, jl), (tt, tl) = runs[J.__name__], runs[T.__name__]
    assert tt == jt and all(0 <= t < V for t in tt)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_graph_print_and_dot_match_jax(tmp_path):
    """ggml_graph_print and ggml_graph_dump_dot describe the same backward
    graph in both packages: node and leaf counts, each node's op, and each
    dot node's colour (params yellow, grads green, leafs gray)."""
    import re

    outs = {}
    for api, mk in ((J, lambda a: jgraph.leaf(jnp.asarray(a))),
                    (T, lambda a: tgraph.leaf(a, device="cpu"))):
        ctx = _ctx(api)
        x = mk(np.ones(3, np.float32))
        api.ggml_set_param(ctx, x)
        y = api.ggml_sum(ctx, api.ggml_mul(ctx, api.ggml_sqr(ctx, x),
                                           mk(np.full(3, 2.0, np.float32))))
        gf = api.ggml_build_forward(y)
        gb = api.ggml_build_backward(ctx, gf, False)
        text = api.ggml_graph_print(gb)
        dot = api.ggml_graph_dump_dot(gb, gf, str(tmp_path / "g.dot"))
        outs[api.__name__] = (
            [re.sub(r"_\d+", "", ln) for ln in text.splitlines()],
            re.findall(r"fillcolor=(\w+)", dot), dot.count("->"))
    assert outs[J.__name__] == outs[T.__name__]
