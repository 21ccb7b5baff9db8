"""The speculative rounds as captured steps (models.speculative,
serving.spec) on the CPU, against the JAX package's jitted round and the
port's own eager form.

A round writes both caches in place and returns the same cache objects; on
the card it is one CUDA graph a (t_eff, d_eff). On the CPU a CapturedStep
runs the round eagerly through the static input and output buffers its
graph would use, so these tests hold that protocol:

  * the in-place round over three rounds gives JAX's round's tokens, counts,
    seeds and lengths bit for bit (GPT-2 f32, test_torch_speculative's
    models: every route differs in summation order only, and no top-2 gap
    is that small), with a round where every draft is accepted (draft =
    target) and one where none is; the cache objects and every buffer
    address stay fixed;
  * the round through the protocol equals its captured.disabled() form,
    greedy and sampled (one generator seed);
  * greedy and sampled rounds make no host sync, so they can be captured;
  * the draw (exponential noise, argmax of p / q) is torch.multinomial's
    own one-sample draw: the same tokens from the same generator state, and
    within total variation 0.03 of p over 20000 draws;
  * a capture registers the round's generator with its graph and puts the
    generator's state back after the warm-up, and runs with Python's
    cyclic collector off (a stub graph stands in for CUDA's);
  * speculative_generate and the engine's tick fetch once a round;
  * the speculative engine gives the JAX speculative engine's tokens.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import speculative as jspec
from ggmlsharp_tpu.serving import Engine as JEngine
from ggmlsharp_tpu.serving import Request as JRequest
from ggmlsharp_tpu_torch.models import captured, gpt2, llama, sampling
from ggmlsharp_tpu_torch.models import speculative as spec
from ggmlsharp_tpu_torch.serving import Engine, Request
from test_torch_captured_decode import _stub_cuda
from test_torch_lbfgs_jit import _NoHostSync
from test_torch_speculative import CFG, _pair

K = 3


@pytest.fixture(scope="module")
def g2():
    """test_torch_speculative's GPT-2 target (key 0) and independent draft
    (key 7), f32, in both packages."""
    jcfg, cfg = jgpt2.GPT2Config(**CFG), gpt2.GPT2Config(**CFG)
    (jt, tt), (jd, td) = _pair(jgpt2, gpt2, jcfg, cfg, 0, 7)
    return jcfg, cfg, jt, tt, jd, td


def _prefilled(cfg, tp, dp, prompt):
    """Port caches as speculative_generate leaves them (target: the prompt;
    draft: all but its last token) and the first seed."""
    B, S = prompt.shape
    tc = gpt2.new_cache(cfg, B, dtype=torch.float32, device="cpu")
    dc = gpt2.new_cache(cfg, B, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(prompt)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    with torch.no_grad():
        lg, _ = gpt2.forward(tp, cfg, toks, tc, pos)
        gpt2.forward(dp, cfg, toks[:, :-1], dc, pos[:, :-1])
    tc.length.fill_(S)
    dc.length.fill_(S - 1)
    a0 = torch.argmax(lg[:, -1], -1).to(torch.int32)
    return tc, dc, torch.stack([toks[:, -1], a0], dim=1)


def _jax_prefilled(jcfg, jt, jd, prompt):
    B, S = prompt.shape
    jtc = jgpt2.new_cache(jcfg, B, dtype=jnp.float32)
    jdc = jgpt2.new_cache(jcfg, B, dtype=jnp.float32)
    toks = jnp.asarray(prompt)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    lg, jtc = jgpt2.forward(jt, jcfg, toks, jtc, pos)
    _, jdc = jgpt2.forward(jd, jcfg, toks[:, :-1], jdc, pos[:, :-1])
    a0 = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    return jtc, jdc, jnp.stack([toks[:, -1], a0], axis=1)


def _prompt(B, S=5, seed=4):
    return np.random.default_rng(seed).integers(
        0, CFG["n_vocab"], (B, S)).astype(np.int32)


@pytest.mark.parametrize("draft,B", [("target", 1), ("independent", 2)])
def test_in_place_round_matches_jax_round(g2, draft, B):
    """Three greedy rounds (B = 1: flat caches; B = 2: head-major) against
    JAX's: tokens, counts, seeds and lengths bit for bit; the round returns
    its input caches, every buffer where it was."""
    jcfg, cfg, jt, tt, jd, td = g2
    if draft == "target":
        jd, td = jt, tt
    prompt = _prompt(B)
    S = prompt.shape[1]
    tc, dc, seed = _prefilled(cfg, tt, td, prompt)
    jtc, jdc, jseed = _jax_prefilled(jcfg, jt, jd, prompt)
    addrs = sampling._addresses(tc) + sampling._addresses(dc)
    rnd = spec.make_spec_round(gpt2.forward, cfg, gpt2.forward, cfg, K)
    jrnd = jspec.make_spec_round(jgpt2.forward, jcfg, jgpt2.forward, jcfg, K)
    n_emits = []
    h = S
    for _ in range(3):
        t_eff = sampling.length_bucket(h + K + 2, cfg.n_ctx)
        em, ne, tc2, dc2, seed = rnd(tt, td, tc, dc, seed, t_eff=t_eff,
                                     d_eff=t_eff)
        jem, jne, jtc, jdc, jseed = jrnd(jt, jd, jtc, jdc, jseed,
                                         t_eff=t_eff, d_eff=t_eff)
        assert tc2 is tc and dc2 is dc
        assert sampling._addresses(tc) + sampling._addresses(dc) == addrs
        np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
        np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
        np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jtc.length))
        np.testing.assert_array_equal(dc.length.numpy(),
                                      np.asarray(jdc.length))
        n_emits += ne.tolist()
        h += int(ne.max())
    if draft == "target":
        assert n_emits == [K + 1] * 3
    else:
        assert 1 in n_emits  # a round where no draft was accepted


def _round_outputs(rnd, args, kw, tc, dc):
    """A round's outputs and both caches' buffers, cloned."""
    em, ne, _, _, seed = rnd(*args, **kw)
    bufs = [t.clone() for t in (*tc.k, *tc.v, tc.length, *dc.k, *dc.v,
                                dc.length)]
    return [em.clone(), ne.clone(), seed.clone()] + bufs


@pytest.mark.parametrize("sampled", [False, True])
def test_protocol_equals_eager_round(g2, sampled):
    """Two rounds through the CapturedStep protocol (static buffers) and in
    the captured.disabled() form give the same outputs and caches, bit for
    bit; the sampled round from one generator seed."""
    _, cfg, _, tt, _, td = g2
    prompt = _prompt(2)
    runs = []
    for eager in (False, True):
        tc, dc, seed = _prefilled(cfg, tt, td, prompt)
        if sampled:
            rnd = spec.make_spec_round_sampled(gpt2.forward, cfg,
                                               gpt2.forward, cfg, K)
            gen = torch.Generator().manual_seed(11)
            extra = (gen, torch.tensor([0.8, 0.0]),
                     torch.tensor([0, 5], dtype=torch.int32),
                     torch.tensor([0.95, 1.0]))
        else:
            rnd = spec.make_spec_round(gpt2.forward, cfg, gpt2.forward, cfg,
                                       K)
            extra = ()
        out = []
        with captured.disabled() if eager else contextlib.nullcontext():
            for _ in range(2):
                o = _round_outputs(rnd, (tt, td, tc, dc, seed, *extra),
                                   dict(t_eff=64, d_eff=64), tc, dc)
                seed = o[2]
                out += o
        runs.append(out)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _llama_engine_models():
    cfg = llama.LlamaConfig(n_vocab=128, n_ctx=64, n_embd=256, n_head=4,
                            n_head_kv=2, n_layer=2, n_ff=512)
    return cfg, llama.synthetic_q4_0_params(cfg, seed=2, device="cpu")


@pytest.mark.parametrize("model", ["gpt2_flat", "llama_flat_int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_round_makes_no_host_sync(g2, model, sampled):
    """The round a CapturedStep captures (draft chain, verify, accept, both
    lengths written in place; the sampled round's draws) reads nothing back
    to the host: GPT-2 over flat f32 caches, and the serving llama over
    flat INT8 ones (path k3's layout)."""
    if model == "gpt2_flat":
        _, cfg, _, tt, _, td = g2
        fwd, tp, dp = gpt2.forward, tt, td
        tc, dc, seed = _prefilled(cfg, tt, td, _prompt(1))
        assert tc.is_flat
    else:
        cfg, tp = _llama_engine_models()
        fwd, dp = llama.forward, tp
        eng = Engine(fwd, cfg, tp, batch_slots=2, int8_kv=True, device="cpu",
                     draft_forward=fwd, draft_params=tp, spec_k=K)
        tc, dc = eng.cache, eng.d_cache
        assert tc.is_flat and tc.int8
        tc.length.copy_(torch.tensor([5, 9], dtype=torch.int32))
        dc.length.copy_(tc.length - 1)
        seed = torch.tensor([[3, 4], [7, 8]], dtype=torch.int32)
    B = seed.shape[0]
    if sampled:
        rnd = spec.make_spec_round_sampled(fwd, cfg, fwd, cfg, K)
        extra = (torch.Generator().manual_seed(1), torch.full((B,), 0.8),
                 torch.full((B,), 4, dtype=torch.int32), torch.full((B,), 0.9))
    else:
        rnd = spec.make_spec_round(fwd, cfg, fwd, cfg, K)
        extra = ()
    length = tc.length
    with torch.no_grad(), _NoHostSync():
        for _ in range(2):
            em, ne, tc2, _, seed = rnd(tp, dp, tc, dc, seed, *extra,
                                       t_eff=64, d_eff=64)
    assert tc2 is tc and tc.length is length
    assert em.shape == (B, K + 1) and bool(((ne >= 1) & (ne <= K + 1)).all())


def test_draw_is_multinomials_draw():
    """_draw equals torch.multinomial(probs, 1) from the same generator
    state, token for token (ATen's one-sample route: exponential noise and
    the argmax of p / q), on rows with zeros and a one-hot row; and over
    20000 draws of a fixed p of 16 categories its frequencies are within
    total variation 0.03 of p (the expected distance is ~0.011)."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(37), 500).astype(np.float32))
    p[3] = 0.0
    p[3, 7] = 1.0  # one-hot (a greedy slot's row)
    p[4, :20] = 0.0
    p[4] /= p[4].sum()
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    for _ in range(3):
        want = torch.multinomial(p, 1, generator=g1)[:, 0].to(torch.int32)
        assert torch.equal(spec._draw(p, g2), want)
    assert int(spec._draw(p, g2)[3]) == 7
    p16 = torch.from_numpy(rng.dirichlet(np.ones(16)).astype(np.float32))
    n = 20000
    got = spec._draw(p16[None].expand(n, 16).contiguous(),
                     torch.Generator().manual_seed(3))
    freq = np.bincount(got.numpy(), minlength=16) / n
    assert 0.5 * np.abs(freq - p16.numpy()).sum() < 0.03


class _RegisteringGraph:
    """A stub CUDAGraph that records the generators registered with it."""

    def __init__(self):
        self.registered = []

    def register_generator_state(self, gen):
        self.registered.append(gen)

    def replay(self):
        pass


def test_capture_registers_the_generator_and_restores_it(monkeypatch):
    """The warm-up draws, its generator state is put back, the graph gets
    the generator registered, and the capture (here run eagerly by the
    stub) draws the numbers the warm-up drew: the first replay draws what
    an eager first round would."""
    _stub_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RegisteringGraph)
    gen = torch.Generator().manual_seed(5)
    draws = []

    def fn(x):
        draws.append(torch.rand(4, generator=gen))
        return x + draws[-1]

    cs = captured.CapturedStep(fn, generators=(gen,))
    g = captured._Graph((torch.zeros(4),))
    cs._capture(g, {})
    assert g.graph.registered == [gen]
    assert len(draws) == 2 and torch.equal(draws[0], draws[1])


def test_capture_runs_with_the_collector_off(monkeypatch):
    """Python's cyclic collector is off while a step is captured (a dead
    graph destroyed inside a capture invalidates it) and back on after,
    also when the capture fails; left off if the caller had it off."""
    import gc

    _stub_cuda(monkeypatch)
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x + 1

    def failing(x):
        seen.append(gc.isenabled())
        if len(seen) == 2:  # the capture, after the warm-up
            raise RuntimeError("captured op refused")
        return x

    assert gc.isenabled()
    for f in (fn, failing):
        seen.clear()
        g = captured._Graph((torch.zeros(2),))
        with contextlib.suppress(RuntimeError):
            captured.CapturedStep(f)._capture(g, {})
        assert seen == [True, False] and gc.isenabled()
    gc.disable()
    try:
        seen.clear()
        captured.CapturedStep(fn)._capture(captured._Graph((torch.zeros(2),)),
                                           {})
        assert seen == [False, False] and not gc.isenabled()
    finally:
        gc.enable()


def _count_fetches(monkeypatch):
    calls = [0]
    cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        calls[0] += 1
        return cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    return calls


def test_speculative_generate_fetches_once_a_round(g2, monkeypatch):
    _, cfg, _, tt, _, td = g2
    rounds = [0]
    make = spec.make_spec_round

    def counting_make(*a, **kw):
        rnd = make(*a, **kw)

        def counted(*args, **kws):
            rounds[0] += 1
            return rnd(*args, **kws)
        return counted

    monkeypatch.setattr(spec, "make_spec_round", counting_make)
    calls = _count_fetches(monkeypatch)
    toks, _ = spec.speculative_generate(
        gpt2.forward, cfg, tt, gpt2.forward, cfg, td,
        torch.from_numpy(_prompt(2)), gpt2.new_cache(cfg, 2, device="cpu"),
        gpt2.new_cache(cfg, 2, device="cpu"), 12, k=K)
    assert toks.shape == (2, 12) and rounds[0] >= 3
    assert calls[0] == rounds[0] + 1  # a0, then one a round


def test_spec_tick_fetches_once(g2, monkeypatch):
    """A tick with live slots and no chunking reads the round back once
    (tokens, counts and next seeds together)."""
    _, cfg, _, tt, _, td = g2
    eng = Engine(gpt2.forward, cfg, tt, batch_slots=2, device="cpu",
                 draft_forward=gpt2.forward, draft_params=td, spec_k=K)
    for i, p in enumerate(_prompt(2).tolist()):
        eng.submit(Request(id=i, prompt=p, max_new_tokens=10))
    eng._admit()
    calls = _count_fetches(monkeypatch)
    for n in range(1, 3):
        assert eng._spec_tick()
        assert calls[0] == n


def test_spec_engine_gives_jax_engine_tokens(g2):
    """The speculative engine (greedy; 3 same-bucket admissions padded to a
    group of 4, one through a registered prefix, slots recycled) gives the
    JAX speculative engine's tokens."""
    jcfg, cfg, jt, tt, jd, td = g2
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, CFG["n_vocab"], n).tolist()
               for n in (4, 9, 6, 7, 5)]
    prefix = prompts[4][:3]
    jeng = JEngine(jgpt2.forward, jcfg, jt, batch_slots=4, max_len=96,
                   int8_kv=False, draft_forward=jgpt2.forward,
                   draft_cfg=jcfg, draft_params=jd, spec_k=K)
    eng = Engine(gpt2.forward, cfg, tt, batch_slots=4, max_len=96,
                 int8_kv=False, cache_dtype=torch.float32, device="cpu",
                 draft_forward=gpt2.forward, draft_params=td, spec_k=K)
    out = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        pid = e.register_prefix(prefix)
        for i, p in enumerate(prompts):
            e.submit(R(id=i, prompt=p, max_new_tokens=8,
                       prefix_id=pid if i == 4 else None))
        out.append({r.id: r.out_tokens for r in e.run()})
    assert out[1] == out[0]
    assert all(len(t) == 8 for t in out[1].values())
