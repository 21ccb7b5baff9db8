"""The port's parallel primitives against the JAX package's on its 8
virtual CPU devices (the conftest): ring attention (causal and not),
pipeline_forward (M > 1 and M = 1), the 1F1B pipeline_train_step (loss and
gradients), and the overlapped row-parallel matmul with Q4_0 and dense
weights. The port's side runs in one spawned world of 4 gloo ranks
(tests/_torch_parallel_ranks.prims); the tolerances are
tests/test_parallel.py's and tests/test_overlap.py's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import _torch_parallel_ranks as ranks
from ggmlsharp_tpu import GType as JGType
from ggmlsharp_tpu import ops as jops
from ggmlsharp_tpu import quantize as jquantize
from ggmlsharp_tpu.parallel import pipeline as jpipe
from ggmlsharp_tpu.parallel.overlap import \
    row_parallel_mul_mat_overlapped as j_overlap
from ggmlsharp_tpu.parallel.ring_attention import ring_attention as j_ring
from ggmlsharp_tpu_torch.parallel.distributed import spawn

WORLD = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("prims"))
    spawn(ranks.prims, WORLD, args=(out,), threads=1,
          init_file=f"{out}/store")
    return [torch.load(f"{out}/prims_{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _mesh(axis="model"):
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD), (axis,))


def _j(t):
    return jnp.asarray(t.numpy())


def _same_on_every_rank(results, key):
    a = results[0][key]
    for r in results[1:]:
        b = r[key]
        if isinstance(a, tuple):
            assert a[0] == b[0]
            for k in a[1]:
                assert torch.equal(a[1][k], b[1][k]), (key, k)
        else:
            assert torch.equal(a, b), key


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(results, causal):
    d = ranks.prim_inputs()
    key, qkv = ("ring_causal", d["ring_c"]) if causal else \
        ("ring_full", d["ring_n"])
    want = np.asarray(j_ring(*map(_j, qkv), _mesh(), seq_axis="model",
                             causal=causal))
    np.testing.assert_allclose(results[0][key].numpy(), want, rtol=2e-4,
                               atol=2e-5)
    _same_on_every_rank(results, key)


def test_ring_attention_matches_flash_reference(results):
    """test_parallel.py's own check: the plain flash attention of JAX."""
    q, k, v = map(_j, ranks.prim_inputs()["ring_c"])
    want = np.asarray(jax.jit(lambda a, b, c: jops.flash_attn(
        a, b, c, masked=True, use_pallas=False))(q, k, v))
    np.testing.assert_allclose(results[0]["ring_causal"].numpy(), want,
                               rtol=2e-4, atol=2e-5)


def test_pipeline_forward_matches_jax(results):
    Ws, bs, x = ranks.prim_inputs()["pf"]
    want = np.asarray(jpipe.pipeline_forward(
        lambda lp, h: jnp.tanh(h @ lp[0] + lp[1]), (_j(Ws), _j(bs)), _j(x),
        _mesh(), axis="model", n_micro=4))
    np.testing.assert_allclose(results[0]["pipe_m4"].numpy(), want,
                               rtol=2e-4, atol=1e-5)
    seq = x.numpy()
    for i in range(8):
        seq = np.tanh(seq @ Ws[i].numpy() + bs[i].numpy())
    np.testing.assert_allclose(results[0]["pipe_m4"].numpy(), seq,
                               rtol=2e-4, atol=1e-5)
    _same_on_every_rank(results, "pipe_m4")


def test_pipeline_single_microbatch_matches_jax(results):
    W, x = ranks.prim_inputs()["p1"]
    want = np.asarray(jpipe.pipeline_forward(lambda w, h: h @ w, _j(W),
                                             _j(x), _mesh(), n_micro=1))
    np.testing.assert_allclose(results[0]["pipe_m1"].numpy(), want,
                               rtol=2e-4, atol=1e-5)
    _same_on_every_rank(results, "pipe_m1")


@pytest.mark.parametrize("M", [4, 8])
def test_pipeline_1f1b_matches_jax(results, M):
    d = ranks.prim_inputs()
    xt, yt = d["tr_xy"][M]
    params = {k: _j(v) for k, v in d["tr"].items()}
    jl, jg = jpipe.pipeline_train_step(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        lambda o, t: jnp.mean((o - t) ** 2), params, _j(xt), _j(yt),
        _mesh(), n_micro=M)
    loss, grads = results[0][f"1f1b_m{M}"]
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # and the sequential value_and_grad, in the port
    p = {k: v.clone().requires_grad_(True) for k, v in d["tr"].items()}
    h = xt
    for i in range(8):
        h = torch.tanh(h @ p["w"][i] + p["b"][i])
    hm, ym = h.reshape(M, 2, 16), yt.reshape(M, 2, 16)
    tot = torch.stack([torch.mean((hm[m] - ym[m]) ** 2)
                       for m in range(M)]).mean()
    tot.backward()
    np.testing.assert_allclose(loss, float(tot.detach()), rtol=1e-5,
                               atol=1e-6)
    for k in p:
        np.testing.assert_allclose(grads[k].numpy(), p[k].grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    _same_on_every_rank(results, f"1f1b_m{M}")


@pytest.mark.parametrize("kind", ["q4_0", "dense"])
def test_overlapped_matmul_matches_jax(results, kind):
    w, x = ranks.prim_inputs()["ov"]
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD), ("model",))
    if kind == "q4_0":
        jw = jax.jit(lambda a: jquantize(a, JGType.Q4_0))(_j(w))
        want = j_overlap(jw, _j(x), mesh, use_pallas=False)
        tol = 1e-5
    else:
        want = j_overlap(_j(w), _j(x), mesh, use_pallas=False)
        tol = 1e-4
    got = results[0][f"overlap_{kind}"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    _same_on_every_rank(results, f"overlap_{kind}")
