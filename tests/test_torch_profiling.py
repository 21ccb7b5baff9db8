"""The port's per-node profiler (utils.profiling.OpProfiler) against the
JAX package's (ggmlsharp_tpu/utils/profiling.py, tests/test_tooling.py:37)
over the same graphs, built from the same numpy data in both packages.

Node names are ``<op>_<uid>`` in both packages; the uid counters differ, so
names are compared with the uid cut off. Values: the tooling test's graph
is exact in f32 (0 tolerance); the decoder-style graph's matmuls and
softmax sum in other orders on the two sides: 1e-5 relative, 1e-6
absolute. Times are host times here and not compared.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.graph import builders as JB
from ggmlsharp_tpu.graph import build_forward as j_build_forward
from ggmlsharp_tpu.graph import leaf as j_leaf
from ggmlsharp_tpu.graph import set_param as j_set_param
from ggmlsharp_tpu.utils import OpProfiler as JOpProfiler
from ggmlsharp_tpu_torch.graph import builders as TB
from ggmlsharp_tpu_torch.graph import build_forward, leaf, set_param
from ggmlsharp_tpu_torch.utils import OpProfiler, graph_print


def _tooling_graph(B, leaf_, set_param_, arr):
    """tests/test_tooling.py::_small_graph: sum(sqr(x) * a)."""
    x = set_param_(leaf_(arr(np.ones((4,), np.float32))))
    a = leaf_(arr(np.full((4,), 2.0, np.float32)))
    return B.sum(B.mul(B.sqr(x), a))


def _attention_graph(B, leaf_, set_param_, arr):
    """One masked softmax attention head and a GELU projection, the ops of
    examples/graph_transformer.py."""
    rng = np.random.default_rng(0)
    S, E = 8, 16
    x = leaf_(arr(rng.standard_normal((S, E)).astype(np.float32)))
    wq, wk, wv = (set_param_(leaf_(arr(
        (rng.standard_normal((E, E)) * 0.2).astype(np.float32))))
        for _ in range(3))
    h = B.rms_norm(x)
    q, k, v = B.mul_mat(wq, h), B.mul_mat(wk, h), B.mul_mat(wv, h)
    att = B.soft_max(B.diag_mask_inf(B.scale_const(B.mul_mat(k, q), 0.25),
                                     0))
    o = B.mul_mat(B.cont(B.transpose(v)), att)
    return B.sum(B.gelu(o))


def _strip(name):
    return re.sub(r"_\d+$", "", name)


GRAPHS = {"tooling": (_tooling_graph, 0.0, 0.0),
          "attention": (_attention_graph, 1e-5, 1e-6)}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_profiler_matches_jax(graph, capsys):
    build, rtol, atol = GRAPHS[graph]
    jf = build(JB, j_leaf, j_set_param, jnp.asarray)
    jg = j_build_forward(jf)
    jp = JOpProfiler(iters=2)
    jp.compute(jg)
    tf = build(TB, lambda v: leaf(v, device="cpu"), set_param,
               torch.from_numpy)
    tg = build_forward(tf)
    tp = OpProfiler(iters=2)
    assert tp.compute(tg) is tg and tg.perf_runs == 1
    assert [(_strip(n), op) for n, op, _ in tp.per_node] == \
        [(_strip(n), op) for n, op, _ in jp.per_node]
    assert all(us > 0 for _, _, us in tp.per_node)
    assert set(tp.rollup()) == {op for _, op, _ in jp.per_node}
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert jn.op == tn.op
        if jn.op != "none":
            np.testing.assert_allclose(tn.data.numpy(), np.asarray(jn.data),
                                       rtol=rtol, atol=atol)
    rep, jrep = tp.report(), jp.report()
    assert rep.splitlines()[0] == jrep.splitlines()[0]
    assert "=== per-op rollup ===" in rep
    assert len(rep.splitlines()) == len(jrep.splitlines())
    # graph_print reads the profiler's run
    assert "perf_runs = 1" in graph_print(tg)
    capsys.readouterr()
    if graph == "tooling":
        assert float(tf.data.reshape(-1)[0]) == 8.0


def test_profiler_values_equal_graph_compute():
    """OpProfiler stores the values Graph.compute stores, bit for bit."""
    tf = _attention_graph(TB, lambda v: leaf(v, device="cpu"), set_param,
                          torch.from_numpy)
    g = build_forward(tf)
    OpProfiler(iters=1).compute(g)
    prof = [n.data.clone() for n in g.nodes if n.op != "none"]
    g.compute()
    plain = [n.data for n in g.nodes if n.op != "none"]
    for a, b in zip(prof, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="iters"):
        OpProfiler(iters=0)
