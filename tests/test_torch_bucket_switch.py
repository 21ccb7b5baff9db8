"""The in-graph length-bucket switch (``t_eff=None``; kernels.graph_switch,
models.captured.CapturedStep.switch) on the CPU, against the JAX package's
``t_eff=None`` forms, which pick the bucket inside one executable with
``lax.switch`` (ggmlsharp_tpu/models/common.py:175-183).

  * the selector's plain version gives JAX's index at every length 0..T,
    for a decode step, a prefill and a speculative round's two caches;
  * make_decode_fns' prefill and step, make_greedy_step and make_spec_round
    called with ``t_eff=None`` (``d_eff=None``) give JAX's logits within
    test_torch_llama's f32 bar (1e-4) and its tokens, at lengths on both
    sides of every bucket boundary of a 1024-row cache (buckets 256, 512,
    1024);
  * the switched step reads nothing back to the host (_NoHostSync), where
    its eager form (captured.disabled(), the bucket read on the host)
    trips the check;
  * a switched key captures one body a bucket combination and one parent
    (stub graphs stand in for CUDA's), each launch adding one body's
    launches and one selector launch.

On the CPU a switched step runs its function at the widest buckets:
attention masks every row past a slot's position, so it computes the
function of the selected bucket (the card's selector picks the body).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.models import speculative as jspec
from ggmlsharp_tpu.models.common import _chunk_buckets as jbuckets
from ggmlsharp_tpu_torch.kernels import _build
from ggmlsharp_tpu_torch.kernels import graph_switch as gs
from ggmlsharp_tpu_torch.models import captured, llama, sampling
from ggmlsharp_tpu_torch.models import speculative as spec
from test_torch_captured_decode import _stub_cuda
from test_torch_lbfgs_jit import _NoHostSync

CFG = dict(n_vocab=64, n_ctx=1024, n_embd=64, n_head=2, n_head_kv=1,
           n_layer=1, n_ff=128)
TOL = 1e-4  # test_torch_llama's f32 (weight-only) bar
CHUNK = 250  # prompt chunk: 250 + 8 steps crosses 256, 508 + 8 crosses 512
STEPS = 8


@pytest.fixture(scope="module")
def models():
    """A one-layer f32 llama (GQA), random from numpy, in both packages."""
    jcfg = jllama.LlamaConfig(**CFG)
    rng = np.random.default_rng(5)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.1
                   + (a == 1)).astype(np.float32),
        jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    return (jcfg, jax.tree.map(jnp.asarray, tree), llama.LlamaConfig(**CFG),
            llama.params_from_jax(tree, device="cpu"))


def _jax_idx(lims, T):
    """JAX's index for each lim, as common.cached_attention computes it."""
    lims = jnp.asarray(lims, jnp.int32)
    return np.asarray(sum((lims > b).astype(jnp.int32)
                          for b in jbuckets(T)[:-1]))


@pytest.mark.parametrize("T", [1024, 2048])
def test_selector_index_equals_jax_idx(T):
    lengths = np.arange(T + 1)
    buckets = sampling._chunk_buckets(T)
    for add in (1, 5, 300):  # a decode step, a round (k = 4), a prefill
        bound = gs.bucket_bound("t_eff", torch.zeros(1, dtype=torch.int32),
                                add, buckets)
        want = _jax_idx(lengths + add, T)
        skipped = len(buckets) - len(bound.buckets)  # buckets below add
        got = [int(gs.select_index((bound._replace(length=torch.tensor(
            [n, n // 2], dtype=torch.int32)),))) for n in lengths]
        np.testing.assert_array_equal(np.asarray(got) + skipped, want)
        # the bucket the index names is JAX's branch's bound
        assert [bound.buckets[i] for i in got[::97]] == [
            buckets[i] for i in want[::97]]
    # two caches (a round's target and draft): idx_t * n_d + idx_d
    t_len, d_len = torch.tensor([300], dtype=torch.int32), \
        torch.tensor([700], dtype=torch.int32)
    both = (gs.bucket_bound("t_eff", t_len, 5, buckets),
            gs.bucket_bound("d_eff", d_len, 5, buckets))
    want = _jax_idx([305], T)[0] * len(buckets) + _jax_idx([705], T)[0]
    assert int(gs.select_index(both)) == want
    assert gs.host_buckets(both) == {"t_eff": 512, "d_eff": 1024}


def _chunks(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["n_vocab"], (1, CHUNK)).astype(np.int32)
            for _ in range(2)]


def test_switched_prefill_and_step_match_jax(models):
    """Two prefill chunks, each followed by STEPS decode steps fed JAX's
    greedy tokens, all at t_eff=None: the steps' lims run 251..258 and
    509..516, both sides of 256 and 512."""
    jcfg, jp, tcfg, tp = models
    jpre, jstep = jsampling.make_decode_fns(jllama.forward, jcfg)
    pre, step = sampling.make_decode_fns(llama.forward, tcfg)
    greedy = sampling.make_greedy_step(llama.forward, tcfg)
    jc = jllama.new_cache(jcfg, 1, dtype=jnp.float32)
    tc = llama.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    gc_ = llama.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    lims = []
    for chunk in _chunks():
        jl, jc = jpre(jp, jnp.asarray(chunk), jc)
        with torch.no_grad():
            tl, tc = pre(tp, torch.from_numpy(chunk), tc)
            pre(tp, torch.from_numpy(chunk), gc_)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        for _ in range(STEPS):
            lims.append(int(tc.length[0]) + 1)
            jl, jc = jstep(jp, jnp.asarray(tok), jc)
            with torch.no_grad():
                tl, tc = step(tp, torch.from_numpy(tok), tc)
                gtok, gc_ = greedy(tp, torch.from_numpy(tok), gc_)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=TOL)
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
            assert gtok.numpy().tolist() == tok.tolist()
    assert min(lims) <= 256 < max(lims) and any(
        n <= 512 for n in lims if n > 256) and max(lims) > 512
    assert int(tc.length[0]) == int(gc_.length[0]) == int(jc.length[0])


def test_switched_round_matches_jax(models):
    """make_spec_round at t_eff = d_eff = None (draft = target, k = 2) from
    a 250-token prompt: JAX's emitted tokens, counts and seeds, round for
    round, the target's lim crossing 256."""
    jcfg, jp, tcfg, tp = models
    K = 2
    (prompt, _) = _chunks()
    jpre, _ = jsampling.make_decode_fns(jllama.forward, jcfg)
    pre, _ = sampling.make_decode_fns(llama.forward, tcfg)
    jtc, jdc = (jllama.new_cache(jcfg, 1, dtype=jnp.float32)
                for _ in range(2))
    ttc, tdc = (llama.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
                for _ in range(2))
    jl, jtc = jpre(jp, jnp.asarray(prompt), jtc)
    _, jdc = jpre(jp, jnp.asarray(prompt[:, :-1]), jdc)
    with torch.no_grad():
        pre(tp, torch.from_numpy(prompt), ttc)
        pre(tp, torch.from_numpy(prompt[:, :-1]), tdc)
    a0 = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    seed = np.concatenate([prompt[:, -1:], a0], 1)
    jrnd = jspec.make_spec_round(jllama.forward, jcfg, jllama.forward, jcfg,
                                 K)
    rnd = spec.make_spec_round(llama.forward, tcfg, llama.forward, tcfg, K)
    jseed, tseed = jnp.asarray(seed), torch.from_numpy(seed)
    lims = []
    for _ in range(4):
        lims.append(int(ttc.length[0]) + K + 1)
        jem, jne, jtc, jdc, jseed = jrnd(jp, jp, jtc, jdc, jseed)
        em, ne, ttc, tdc, tseed = rnd(tp, tp, ttc, tdc, tseed)
        assert em.tolist() == np.asarray(jem).tolist()
        assert ne.tolist() == np.asarray(jne).tolist()
        assert tseed.tolist() == np.asarray(jseed).tolist()
        tseed = tseed.clone()  # the round's buffer is rewritten next round
    assert min(lims) <= 256 < max(lims)
    assert int(ttc.length[0]) == int(jtc.length[0])
    assert int(tdc.length[0]) == int(jdc.length[0])


def test_switched_step_makes_no_host_read(models):
    """The switched greedy step and round read nothing back; their eager
    forms (the bucket read on the host, as JAX's disable_jit reads its
    switch index) trip the same check: the control."""
    _, _, tcfg, tp = models
    greedy = sampling.make_greedy_step(llama.forward, tcfg)
    rnd = spec.make_spec_round(llama.forward, tcfg, llama.forward, tcfg, 2)
    cache = llama.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    dc = llama.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    cache.length.fill_(300)
    dc.length.fill_(299)
    tok = torch.tensor([[3]], dtype=torch.int32)
    seed = torch.tensor([[3, 4]], dtype=torch.int32)
    with torch.no_grad():
        with _NoHostSync():
            greedy(tp, tok, cache)
            rnd(tp, tp, cache, dc, seed)
        with captured.disabled():
            with pytest.raises(RuntimeError, match="host sync"), \
                    _NoHostSync():
                greedy(tp, tok, cache)
            with pytest.raises(RuntimeError, match="host sync"), \
                    _NoHostSync():
                rnd(tp, tp, cache, dc, seed)


class _KeptGraph:
    """Stands in for torch.cuda.CUDAGraph(keep_graph=True)."""

    made = []

    def __init__(self, keep_graph=False):
        self.keep_graph = keep_graph
        _KeptGraph.made.append(self)

    def raw_cuda_graph(self):
        return id(self)


class _Parent:
    """Stands in for graph_switch.ParentGraph: counts its launches."""

    def __init__(self, bodies, bounds):
        self.bodies, self.bounds, self.design = bodies, bounds, "switch"

    def launch(self):
        _build.check("graph_switch", 0)


def test_switch_captures_one_body_a_bucket(monkeypatch):
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _KeptGraph)
    monkeypatch.setattr(gs, "ParentGraph", _Parent)
    _KeptGraph.made.clear()
    seen = []
    length = torch.tensor([4], dtype=torch.int32)

    def fn(x, t_eff, d_eff):  # counts as two launches
        seen.append((int(length[0]), t_eff, d_eff))
        _build.check("attn_decode", 0)
        _build.check("matmul_q4_0", 0)
        length.add_(1)
        return x * t_eff + d_eff

    cs = captured.CapturedStep(fn, state=(length,))
    sw = captured._Switch((torch.ones(2),))
    sw.inputs[0].fill_(1.0)
    bounds = (gs.bucket_bound("t_eff", length, 1, (256, 512)),
              gs.bucket_bound("d_eff", length, 1, (256, 512, 1024)))
    _build.reset_launches()
    captured.reset_counts()
    cs._capture_switch(sw, bounds, {}, torch.device("cpu"))
    # the warm-up at the widest buckets (state put back), then one body a
    # combination in itertools.product order, each from the caller's state
    assert seen[0] == (4, 512, 1024)
    assert [s[1:] for s in seen[1:]] == [(t, d) for t in (256, 512)
                                         for d in (256, 512, 1024)]
    assert all(s[0] == 4 + i for i, s in enumerate(seen[1:]))  # no restore
    assert len(_KeptGraph.made) == 6 and all(g.keep_graph
                                             for g in _KeptGraph.made)
    assert sw.parent.bodies == _KeptGraph.made
    assert torch.equal(sw.outputs[0], torch.full((2,), 512.0 + 1024))
    assert captured.COUNTS["captures"] == 1
    assert captured.COUNTS["switch_bodies"] == 6
    assert captured.SWITCH["design"] == "switch"
    assert _build.LAUNCHES["attn_decode"] == 0  # the capture counts none
    for n in (1, 2):
        cs._launch_switch(sw)
        assert _build.LAUNCHES["attn_decode"] == n
        assert _build.LAUNCHES["matmul_q4_0"] == n
        assert _build.LAUNCHES["graph_switch"] == n
    assert captured.COUNTS["replays"] == 2
    _build.reset_launches()
    captured.reset_counts()
