"""The port's staged ``Graph.compute`` (graph/core.py: the DAG as one
function of its inputs, run through a CapturedStep held on the Graph; on
the card one captured CUDA graph a topology and input spec, inputs copied
in at every compute, each node's value a copy of the graph's output)
against the JAX package's jitted ``Graph.compute``, on the CPU, where the
same function runs eagerly through the same buffers.

Bars as in test_torch_graph.py: the decoder's values and gradients to 1e-4
relative (two layers of products in f32 in another summation order), the
Hessian-vector products of a backward-of-backward graph to rtol 1e-5 /
atol 1e-6. Each graph is computed twice, the second time after
``set_data`` / ``set_f32`` on its inputs: the same staged step serves both
(one key), both computes agree with JAX's, and a value held from the first
compute is unchanged by the second. The decoder's forward and backward
graphs (flash_attn on its plain route: the materialised scores and
diag_mask_inf) compute under the dispatch mode that refuses every read
back to the host and every tensor made from host data (as a CUDA graph
capture would); its controls show the mode firing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.graph import builders as B
from ggmlsharp_tpu_torch.graph import build_forward, leaf, set_data
from ggmlsharp_tpu_torch.ops import mul_mat
from test_torch_adam_captured import _NoHostTraffic
from test_torch_graph import _backward, _ns, decoder

V, E, S, H = 48, 32, 12, 4


def _weights(rng):
    shapes = [(V, E)] + [(E, E)] * 4 + [(4 * E, E), (E, 4 * E)]
    return [rng.standard_normal(s).astype(np.float32) * 0.1
            for s in shapes + shapes[1:]]


def _decoder_runs(pkg, weights, toks2, onehot, w0b):
    """The decoder's loss graph computed twice: the first tokens and
    weights, then new tokens and a new wte; the values of both computes,
    the first one's node values as held."""
    G = _ns(pkg)
    tok, logits, ws = decoder(G, weights, S, H)
    cast = (lambda a: a) if pkg == "torch" else jnp.asarray
    G.set_data(tok, cast(toks2[0]))
    f = G.B.sum(G.B.mul(G.B.soft_max(logits), G.mk(onehot)))
    gf, gb = _backward(G, f)
    first = [G.out(logits), G.out(f)] + [G.out(w.grad) for w in ws]
    held = (logits.data, ws[0].grad.data)
    step = getattr(gb, "_step", None)
    G.set_data(tok, cast(toks2[1]))
    G.set_data(ws[0], cast(w0b))
    gf.reset()
    G.set_f32(f.grad, 1.0)
    gb.compute()
    second = [G.out(logits), G.out(f)] + [G.out(w.grad) for w in ws]
    return first, second, held, (step, gb)


def test_decoder_computed_twice_matches_jax():
    rng = np.random.default_rng(9)
    weights = _weights(rng)
    toks2 = [rng.integers(0, V, S).astype(np.int32) for _ in range(2)]
    onehot = np.eye(V, dtype=np.float32)[rng.integers(0, V, S)]
    w0b = rng.standard_normal((V, E)).astype(np.float32) * 0.1
    t1, t2, held, (step, gb) = _decoder_runs("torch", weights, toks2, onehot,
                                             w0b)
    j1, j2, _, _ = _decoder_runs("jax", weights, toks2, onehot, w0b)
    for got, want in ((t1, j1), (t2, j2)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max() + 1e-7)
    assert not np.allclose(t1[0], t2[0])  # the inputs did change
    # the values held from the first compute are those it gave
    np.testing.assert_array_equal(held[0].numpy(), t1[0])
    np.testing.assert_array_equal(held[1].numpy(), t1[2])
    # one staged step, one key, for both computes
    assert gb._step is step and len(step._graphs) == 1
    assert gb.perf_runs == 2


def _hvp_runs(pkg, x1v, x2v, wv):
    """y = sum(gelu(mul_mat(w, x1)) * x2) + sum(x1^3); its gradient, then
    build_backward(gb, keep=True) seeded with ones: H·1 in (x1, x2); each
    computed at (x1v[0], x2v[0]) and again at (x1v[1], x2v[1])."""
    G = _ns(pkg)
    cast = (lambda a: a) if pkg == "torch" else jnp.asarray
    x1 = G.set_param(G.mk(x1v[0]))
    x2 = G.set_param(G.mk(x2v[0]))
    w = G.mk(wv)
    y = G.B.add(G.B.sum(G.B.mul(G.B.gelu(G.B.mul_mat(w, x1)), x2)),
                G.B.sum(G.B.mul(G.B.mul(x1, x1), x1)))
    _, gb = _backward(G, y)
    g1, g2 = x1.grad, x2.grad
    gbb = G.bwd(gb, keep=True)
    out = []
    for i in range(2):
        G.set_data(x1, cast(x1v[i]))
        G.set_data(x2, cast(x2v[i]))
        gb.reset()
        G.set_f32(y.grad, 1.0)  # keep=True made fresh seeds; y's is set
        G.set_f32(g1.grad, 1.0)
        G.set_f32(g2.grad, 1.0)
        gbb.compute()
        out += [G.out(y), G.out(g1), G.out(g2), G.out(x1.grad),
                G.out(x2.grad)]
    return out, gbb


def test_hvp_graph_computed_twice_matches_jax():
    rng = np.random.default_rng(5)
    x1v = [rng.standard_normal(6).astype(np.float32) for _ in range(2)]
    x2v = [rng.standard_normal(4).astype(np.float32) for _ in range(2)]
    wv = rng.standard_normal((4, 6)).astype(np.float32) * 0.5
    got, gbb = _hvp_runs("torch", x1v, x2v, wv)
    want, _ = _hvp_runs("jax", x1v, x2v, wv)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[3], got[8])  # H·1 moved with the inputs
    assert len(gbb._step._graphs) == 1


def test_quantized_leaf_is_passed_by_its_planes():
    """A QTensor leaf is an input of the staged function (its planes);
    computing after set_data on the activations equals ops.mul_mat."""
    rng = np.random.default_rng(3)
    w = quantize(torch.from_numpy(
        rng.standard_normal((8, 64)).astype(np.float32)), GType.Q8_0)
    xs = [rng.standard_normal((3, 64)).astype(np.float32) for _ in range(2)]
    x = leaf(xs[0], device="cpu")
    y = B.mul_mat(leaf(w), x)
    gf = build_forward(y)
    for xv in xs:
        set_data(x, xv)
        gf.compute()
        torch.testing.assert_close(y.data, mul_mat(w, torch.from_numpy(xv)),
                                   rtol=0, atol=0)
    assert len(gf._step._graphs) == 1


def test_build_expand_drops_the_staged_step():
    G = _ns("torch")
    a = G.mk(np.ones(3, np.float32))
    b = G.B.add(a, a)
    gf = G.fwd(b)
    gf.compute()
    first = gf._step
    assert first is not None
    c = G.B.mul(b, b)
    gf.build_expand(c)
    assert gf._step is None
    gf.compute()
    assert gf._step is not first
    np.testing.assert_array_equal(G.out(c), np.full(3, 4.0, np.float32))


def test_decoder_graph_compute_makes_no_host_sync():
    rng = np.random.default_rng(9)
    G = _ns("torch")
    tok, logits, _ = decoder(G, _weights(rng), S, H)
    G.set_data(tok, rng.integers(0, V, S).astype(np.int32))
    onehot = np.eye(V, dtype=np.float32)[rng.integers(0, V, S)]
    f = G.B.sum(G.B.mul(G.B.soft_max(logits), G.mk(onehot)))
    gf = G.fwd(f)
    gb = G.bwd(gf)
    gf.reset()
    G.set_f32(f.grad, 1.0)
    with _NoHostTraffic():
        gf.compute()
        gb.compute()
    assert np.isfinite(G.out(f)).all()


@pytest.mark.parametrize("kind", ["sync", "copy"])
def test_a_host_sync_in_a_node_fires_the_check(kind):
    """The control: a node whose op reads its input back (item(), but on
    the meta device of shape inference), or masks with a tensor made from
    host data (as ggml's diag_mask_inf once did), raises under the
    mode."""
    G = _ns("torch")
    a = G.mk(np.ones(3, np.float32))
    if kind == "sync":
        b = G.B.map_unary(a, lambda t: t if t.is_meta
                          else t * t.sum().item())
    else:
        b = G.B.map_unary(a, lambda t: torch.where(
            t > 2, torch.tensor(0.0, device=t.device), t))
    gf = G.fwd(b)
    with pytest.raises(RuntimeError, match=f"host {kind}"), _NoHostTraffic():
        gf.compute()
