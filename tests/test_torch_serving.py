"""The port's serving slice against the JAX package on the CPU: flat and
INT8 KV caches, the sampler, the flat-cache llama.forward, the
continuous-batching Engine and its HTTP server.

Weights cross as ggml wire bytes (test_torch_llama.to_port_tree), so both
packages hold bit-identical parameters of the small llama of
test_torch_llama (2 layers, n_embd 256, GQA n_rep 2, E_kv 128). JAX's
decode-attention kernel runs in its exact f32 mode (set_mm_dot("f32")), the
mode the port computes in.

Tolerances on logits are test_torch_llama's: 1e-4 weight-only (the two
packages differ in f32 summation order and libm ulps) and 2e-2 with the
Q8_0 activation round trip (a one-ulp input difference can move one
activation by a whole Q8 step). Tokens must agree wherever the JAX top-2
gap exceeds the tolerance.
"""
import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.models import kv_cache as jkvc
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.serving import Engine as JEngine
from ggmlsharp_tpu.serving import Request as JRequest
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import kv_cache as kvc
from ggmlsharp_tpu_torch.models import llama, sampling
from ggmlsharp_tpu_torch.serving import Engine, EngineServer, Request
from test_torch_llama import CFG, to_port_tree


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package: its matmuls multiply f32 operands exactly on the CPU in
    either of its modes (DEFAULT precision is f32 there). The port's "bf16"
    function is held against JAX in test_torch_mm_dot.py."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


PROMPTS = [[5, 17, 99], [7, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11], [11],
           [3, 3, 3, 3]]  # uneven, one longer than 8
N_NEW = 6


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**CFG)
    raw = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    jq = jllama.quantize_params(raw, JGType.Q4_0, swar=False)
    tq = llama.params_from_jax(to_port_tree(jq), device="cpu")
    return jcfg, jq, llama.LlamaConfig(**CFG), tq


@pytest.fixture
def exact_jax():
    """JAX's decode-attention kernel in its exact f32 mode."""
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot("f32")
    yield
    jkcfg.set_mm_dot(prev)


@pytest.fixture(params=[(False, 1e-4), (True, 2e-2)],
                ids=["weight_only", "q8_acts"])
def acts(request, monkeypatch):
    quant_acts, tol = request.param
    monkeypatch.setattr(get_config(), "quantize_activations", quant_acts)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if quant_acts else "0")
    return tol


def _engine(tq, tcfg, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("int8_kv", True)
    return Engine(llama.forward, tcfg, tq, device="cpu", **kw)


def _serve(eng, prompts=PROMPTS, n_new=N_NEW, **req_kw):
    for i, p in enumerate(prompts):
        eng.submit(Request(id=i, prompt=list(p), max_new_tokens=n_new,
                           **req_kw))
    return {r.id: r for r in eng.run()}


# --- caches -------------------------------------------------------------------

@pytest.mark.parametrize("flat,int8,dtype", [
    (False, True, "bfloat16"), (True, True, "bfloat16"),
    (True, False, "bfloat16"), (True, False, "float32")])
def test_cache_writes_match_jax(flat, int8, dtype):
    """update_layer(_flat) writes the same rows (and INT8 scales) at the
    same per-slot positions as JAX, and read_layer dequantizes alike: bit
    for bit."""
    rng = np.random.default_rng(5)
    B, H, S, D, T = 2, 2, 3, 64, 16
    rows = [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(2)]
    rows[0][0, 1, 2] = 0.0  # a zero row: scale 0, values 0
    pos = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    jc = jkvc.init_cache(1, B, H, T, D, dtype=getattr(jnp, dtype),
                         int8=int8, flat=flat)
    tc = kvc.init_cache(1, B, H, T, D, dtype=getattr(torch, dtype),
                        int8=int8, flat=flat, device="cpu")
    assert tc.is_flat == flat and tc.int8 == int8 and tc.max_len == T
    if flat:  # element-order rows [B, S, H*D], as merge_heads gives
        fl = [r.transpose(0, 2, 1, 3).reshape(B, S, H * D) for r in rows]
        jc = jkvc.update_layer_flat(jc, 0, *map(jnp.asarray, fl),
                                    jnp.asarray(pos))
        kvc.update_layer_flat(tc, 0, *map(torch.from_numpy, fl),
                              torch.from_numpy(pos))
    else:
        jc = jkvc.update_layer(jc, 0, *map(jnp.asarray, rows),
                               jnp.asarray(pos))
        kvc.update_layer(tc, 0, *map(torch.from_numpy, rows),
                         torch.from_numpy(pos))
        for got, want in zip(kvc.read_layer(tc, 0),
                             jkvc.read_layer(jc, 0)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bufs = [(tc.k, jc.k), (tc.v, jc.v)]
    if int8:
        bufs += [(tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)]
    for tb, jb in bufs:
        np.testing.assert_array_equal(
            tb[0].float().numpy(), np.asarray(jb[0].astype(jnp.float32)))
        assert str(tb[0].dtype).split(".")[1] == str(jb[0].dtype)


def test_quant_rows_matches_jax():
    """Absmax/127 scales, round half to even, clip, zero rows."""
    x = np.zeros((3, 8), np.float32)
    x[0] = [127.0, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5, 1.5]  # scale 1: ties
    x[1] = np.random.default_rng(0).standard_normal(8)
    jq, js = jkvc._quant_rows(jnp.asarray(x))
    tq, ts = kvc._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0].tolist() == [127, 2, 4, -2, -4, 0, 0, 2]
    assert float(ts[2, 0]) == 0.0 and not tq[2].any()


def test_new_cache_layout_rule():
    """INT8 takes the flat cache, a float cache head-major (the JAX
    package's defaults); an explicit flat= wins. An INT8 engine whose
    E_kv is not a multiple of 128 takes a head-major INT8 cache, as the JAX
    engine does."""
    cfg = llama.LlamaConfig(**CFG)
    assert llama.new_cache(cfg, 1, int8=True, device="cpu").is_flat
    assert not llama.new_cache(cfg, 1, device="cpu").is_flat
    assert llama.new_cache(cfg, 1, flat=True, device="cpu").is_flat
    assert not llama.new_cache(cfg, 1, int8=True, flat=False,
                               device="cpu").is_flat
    narrow = llama.LlamaConfig(**{**CFG, "n_head_kv": 1})
    assert not llama.new_cache(narrow, 1, int8=True, device="cpu").is_flat
    eng = Engine(llama.forward, narrow, {}, int8_kv=True, device="cpu")
    assert eng.cache.int8 and not eng.cache.is_flat


# --- sampler ------------------------------------------------------------------

def test_sample_token_matches_jax(monkeypatch):
    """Repetition penalty, the top-k and top-p masks, and the greedy choice
    equal JAX's. JAX's truncated logits are taken at its categorical draw."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 40)).astype(np.float32) * 3
    recent = np.array([[0, 5, -1, -1], [7, 7, 3, -1], [-1, -1, -1, -1]],
                      np.int32)
    jpen = np.asarray(jsampling.apply_repeat_penalty(
        jnp.asarray(logits), jnp.asarray(recent), 1.3))
    tpen = sampling.apply_repeat_penalty(torch.from_numpy(logits),
                                         torch.from_numpy(recent), 1.3)
    np.testing.assert_array_equal(tpen.numpy(), jpen)

    seen = {}
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: seen.setdefault("lg", lg)
                        .argmax(axis))
    for top_k, top_p in ((5, 1.0), (0, 0.6), (8, 0.9)):
        seen.clear()
        jsampling.sample_token(jnp.asarray(jpen), jax.random.PRNGKey(0),
                               temperature=0.8, top_k=top_k, top_p=top_p)
        want = np.asarray(seen["lg"])
        got = sampling.filter_logits(tpen, 0.8, top_k, top_p).numpy()
        np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
        keep = want > -1e29
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
        gen = torch.Generator().manual_seed(0)
        for _ in range(20):  # draws stay inside the kept set
            tok = sampling.sample_token(tpen, gen, 0.8, top_k, top_p)
            assert keep[np.arange(3), tok[:, 0].numpy()].all()

    for pen in (1.0, 3.0):
        jt = jsampling.sample_token(jnp.asarray(logits), temperature=0.0,
                                    repeat_penalty=pen,
                                    recent_tokens=jnp.asarray(recent))
        tt = sampling.sample_token(torch.from_numpy(logits),
                                   temperature=0.0, repeat_penalty=pen,
                                   recent_tokens=torch.from_numpy(recent))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tt.dtype == torch.int32


def test_recent_window_and_generate_sampling(models):
    """_recent_window pads like JAX's; generate takes the sampling
    arguments with a torch.Generator (top_k=1 is greedy whatever the
    draw)."""
    hist = np.array([[4, 5, 6]], np.int32)
    np.testing.assert_array_equal(
        sampling._recent_window(hist, 5).numpy(),
        np.asarray(jsampling._recent_window(hist, 5)))
    with pytest.raises(ValueError):
        sampling._recent_window(hist, 0)
    _, _, tcfg, tq = models
    prompt = torch.tensor([PROMPTS[0]], dtype=torch.int32)
    greedy, _ = sampling.generate(llama.forward, tcfg, tq, prompt,
                                  llama.new_cache(tcfg, 1, device="cpu"), 4,
                                  repeat_penalty=1.5)
    topk1, _ = sampling.generate(llama.forward, tcfg, tq, prompt,
                                 llama.new_cache(tcfg, 1, device="cpu"), 4,
                                 temperature=0.7, top_k=1,
                                 rng=torch.Generator().manual_seed(1),
                                 repeat_penalty=1.5)
    assert torch.equal(greedy, topk1)
    step = sampling.make_greedy_step(llama.forward, tcfg)
    cache = llama.new_cache(tcfg, 1, device="cpu")
    prefill, _ = sampling.make_decode_fns(llama.forward, tcfg)
    lg, cache = prefill(tq, prompt, cache, t_eff=tcfg.n_ctx)
    nxt, cache = step(tq, lg.argmax(-1, keepdim=True).int(), cache,
                      t_eff=tcfg.n_ctx)
    assert nxt.shape == (1, 1) and nxt.dtype == torch.int32
    assert int(cache.length[0]) == 4


# --- flat INT8 llama.forward ----------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 5, 6))
def _jfwd(p, cfg, tokens, cache, pos, bound, cached):
    return jllama.forward(p, cfg, tokens, cache, pos, prefix_bound=bound,
                          cached_prefix=cached)


def test_flat_int8_forward_matches_jax(models, exact_jax, acts):
    """B = 2 with uneven npast over a flat INT8 cache: a 12-token prefill
    (flash over the fresh K/V), three decode steps (attn_decode), a 3-token
    step (einsum over the dequantized live rows) and a 10-token step over
    the live prefix (flash over a head-major copy).

    Weight-only, each call starts both packages from the same cache,
    JAX's. A one-ulp f32 difference in a K/V value (summation order, libm)
    can move its INT8 rounding by a whole step, and every later call reads
    that element: on this input one V element of the prefill's 6144 flips,
    and moves the next call's logits by 1.5e-4, past the weight-only bar.
    So the cache a call writes is held on its own: scales to 1e-5 relative
    (each is the largest of a row's 256-term f32 dot products over 127,
    and the two packages' sums differ there by up to ten ulps), INT8
    values within one step, and at most one element in a thousand a step
    apart (a flip needs the value within an ulp or so of a rounding
    boundary). With the Q8_0 activation round trip each package runs on
    the cache it wrote itself, and a wrong INT8 value or scale shows in
    the next call's logits at the 2e-2 bar."""
    jcfg, jq, tcfg, tq = models
    rng = np.random.default_rng(11)
    jc = jllama.new_cache(jcfg, 2, int8=True, max_len=64)
    tc = llama.new_cache(tcfg, 2, int8=True, max_len=64, device="cpu")
    assert tc.is_flat and tc.int8 and jkvc.is_flat(jc)
    length = np.array([12, 12], np.int32)
    calls = [(12, None), (1, None), (1, None), (1, None), (3, None),
             (10, True)]
    for i, (S, cached) in enumerate(calls):
        toks = rng.integers(0, CFG["n_vocab"], (2, S)).astype(np.int32)
        start = np.zeros(2, np.int32) if i == 0 else length
        pos = (start[:, None] + np.arange(S, dtype=np.int32)[None])
        jl, jc = _jfwd(jq, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos),
                       64, cached)
        with torch.no_grad():
            tl, tc = llama.forward(tq, tcfg, torch.from_numpy(toks), tc,
                                   torch.from_numpy(pos), prefix_bound=64,
                                   cached_prefix=cached)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=acts, err_msg=f"call {i} (S={S})")
        if not get_config().quantize_activations:
            for name in ("k_scale", "v_scale", "k", "v"):  # per layer
                want = np.asarray(getattr(jc, name))
                got = getattr(tc, name)
                have = torch.stack(got).numpy()
                if name.endswith("scale"):
                    np.testing.assert_allclose(have, want, rtol=1e-5, atol=0,
                                               err_msg=name)
                else:
                    step = np.abs(have.astype(np.int32) - want)
                    assert step.max() <= 1, (name, i)
                    assert np.count_nonzero(step) <= step.size // 1000, \
                        (name, i, np.count_nonzero(step))
                for t, w in zip(got, want):
                    t.copy_(torch.from_numpy(w.copy()))
        length = pos[:, -1] + 1
        if i == 0:
            length = np.array([12, 7], np.int32)  # slot 1: 5 pad rows
        jc = jkvc.KVCache(jc.k, jc.v, jc.k_scale, jc.v_scale,
                          jnp.asarray(length))


# --- the engine -------------------------------------------------------------------

def test_engine_matches_sequential_generate(models):
    """INT8 flat engine, 2 slots, 4 uneven prompts (slots recycled): each
    request's tokens equal sequential generate over a 1-slot INT8 cache.
    Decode steps compute alike; a prompt of at most 8 tokens is prefilled
    by generate over its quantized rows and by the engine (a 16-row
    bucket) over its fresh rows, a difference of INT8 rounding that this
    model's top-2 gaps absorb."""
    _, _, tcfg, tq = models
    eng = _engine(tq, tcfg)
    assert eng.cache.is_flat and eng.cache.int8
    got = _serve(eng)
    assert len(got) == len(PROMPTS)
    for i, p in enumerate(PROMPTS):
        want, _ = sampling.generate(
            llama.forward, tcfg, tq, torch.tensor([p], dtype=torch.int32),
            llama.new_cache(tcfg, 1, int8=True, device="cpu"), N_NEW)
        assert got[i].out_tokens == want[0].tolist(), i
        assert got[i].error is None and got[i].done
    st = eng.stats()
    assert st["finished"] == 0 and st["live_slots"] == 0  # run() drained
    assert st["tokens_emitted"] == len(PROMPTS) * N_NEW


def _jax_slot_logits(jcfg, jq, prompt, toks, max_len):
    """The logits that chose each JAX engine token of one request, computed
    as the engine does: a 16-row bucketed prefill over the fresh K/V, then
    single-token steps over a flat INT8 cache."""
    c = jllama.new_cache(jcfg, 1, int8=True, max_len=max_len)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :len(prompt)] = prompt
    pos = np.arange(16, dtype=np.int32)[None]
    lg, c = _jfwd(jq, jcfg, jnp.asarray(padded), c, jnp.asarray(pos), 16,
                  None)
    rows = [np.asarray(lg)[0, len(prompt) - 1]]
    n = len(prompt)
    for t in toks[:-1]:
        c = jkvc.KVCache(c.k, c.v, c.k_scale, c.v_scale,
                         jnp.asarray([n], jnp.int32))
        lg, c = _jfwd(jq, jcfg, jnp.asarray([[t]], jnp.int32), c,
                      jnp.asarray([[n]], jnp.int32), 64, None)
        rows.append(np.asarray(lg)[0, 0])
        n += 1
    return np.stack(rows)


def test_engine_matches_jax_engine(models, exact_jax, acts):
    """The port's INT8 engine against the JAX package's, request by
    request: each port token is the JAX argmax up to the tolerance (so the
    tokens agree wherever the JAX top-2 gap exceeds it); after a near-tie
    flip the two runs part and the comparison stops."""
    jcfg, jq, tcfg, tq = models
    jeng = JEngine(jllama.forward, jcfg, jq, batch_slots=2, int8_kv=True,
                   max_len=64)
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(id=i, prompt=list(p), max_new_tokens=N_NEW))
    jout = {r.id: r.out_tokens for r in jeng.run()}
    got = _serve(_engine(tq, tcfg, max_len=64))
    for i, p in enumerate(PROMPTS):
        jl = _jax_slot_logits(jcfg, jq, p, jout[i], 64)
        for j, tok in enumerate(got[i].out_tokens):
            assert jl[j, tok] >= jl[j].max() - acts, (i, j)
            if tok != jout[i][j]:
                break


def test_engine_window_matches_single_step(models):
    """A decode window (k steps, one fetch) gives the tokens and logprobs
    of single steps."""
    _, _, tcfg, tq = models
    runs = []
    for W in (1, 32):
        eng = _engine(tq, tcfg, multi_step=W)
        runs.append(_serve(eng, want_logprobs=True))
        assert eng.stats()["decode_forwards"] > 0
    for i in range(len(PROMPTS)):
        a, b = runs[0][i], runs[1][i]
        assert a.out_tokens == b.out_tokens
        assert len(a.out_logprobs) == N_NEW
        np.testing.assert_allclose(a.out_logprobs, b.out_logprobs,
                                   rtol=0, atol=1e-5)
        assert all(lp <= 0 for lp in a.out_logprobs)


def test_engine_eos_stop_and_overlong(models):
    """eos and stop sequences end a request at the matching token; a
    prompt of max_len tokens is rejected; a budget past max_len is cut."""
    _, _, tcfg, tq = models
    base = _serve(_engine(tq, tcfg, max_len=32), prompts=PROMPTS[:1],
                  n_new=8)[0].out_tokens
    eng = _engine(tq, tcfg, max_len=32)
    eng.submit(Request(id=0, prompt=PROMPTS[0], max_new_tokens=8,
                       eos_id=base[2]))
    eng.submit(Request(id=1, prompt=PROMPTS[0], max_new_tokens=8,
                       stop=[[base[3], base[4]]]))
    eng.submit(Request(id=2, prompt=[1] * 32, max_new_tokens=4))
    eng.submit(Request(id=3, prompt=[1] * 28, max_new_tokens=10))
    out = {r.id: r for r in eng.run()}
    assert out[0].out_tokens == base[:base.index(base[2]) + 1]
    assert out[1].out_tokens[-2:] == [base[3], base[4]]
    assert out[1].out_tokens == base[:len(out[1].out_tokens)]
    assert out[2].error and "max_len" in out[2].error and \
        not out[2].out_tokens
    assert out[3].error is None and len(out[3].out_tokens) == 4


def test_engine_slot_recycling_and_cancel(models):
    """Five requests over two slots all finish; a cancelled pending request
    ends with error 'cancelled' and frees nothing it did not hold."""
    _, _, tcfg, tq = models
    eng = _engine(tq, tcfg)
    for i in range(5):
        eng.submit(Request(id=i, prompt=[3 + i, 9], max_new_tokens=3))
    assert eng.cancel(4) and not eng.cancel(99)
    out = {r.id: r for r in eng.run()}
    assert [len(out[i].out_tokens) for i in range(4)] == [3, 3, 3, 3]
    assert out[4].error == "cancelled" and not out[4].out_tokens
    assert eng.stats()["prefill_dispatches"] >= 2
    assert eng.cache.length.tolist() == [0, 0]


def test_engine_sampled_requests(models):
    """Requests with sampling parameters take the per-slot sampler: top_k=1
    is greedy whatever the draw, and the repetition penalty gives
    sequential generate's penalized greedy tokens. The penalty's prompts
    are longer than 8 tokens, so that generate's prefill, like the
    engine's bucketed one, attends the fresh rows: a penalty of 1.5 makes
    near ties that the INT8 rounding of shorter prompts' rows can flip."""
    _, _, tcfg, tq = models
    greedy = _serve(_engine(tq, tcfg))
    topk1 = _serve(_engine(tq, tcfg), temperature=0.9, top_k=1)
    for i in range(len(PROMPTS)):
        assert topk1[i].out_tokens == greedy[i].out_tokens
    long_prompts = [PROMPTS[1], [3] * 9]
    pen = _serve(_engine(tq, tcfg), prompts=long_prompts,
                 repeat_penalty=1.5, repeat_last_n=4)
    for i, p in enumerate(long_prompts):
        want, _ = sampling.generate(
            llama.forward, tcfg, tq, torch.tensor([p], dtype=torch.int32),
            llama.new_cache(tcfg, 1, int8=True, device="cpu"), N_NEW,
            repeat_penalty=1.5, repeat_last_n=4)
        assert pen[i].out_tokens == want[0].tolist(), i


def test_engine_prefix_caching(models):
    """Registered prefix rows install into the INT8 slots and the suffix
    prefills over them: the tokens equal the engine without the prefix
    (the suffix attends the installed rows dequantized, so they are held
    to the JAX engine's rule: equal wherever the plain engine's top-2 gap
    exceeds the weight-only tolerance) and a bad prefix is rejected."""
    _, _, tcfg, tq = models
    prefix = [9, 42, 17, 5, 60]
    prompts = [prefix + [7, 1], prefix + [3, 3, 3], prefix]
    plain = _serve(_engine(tq, tcfg), prompts=prompts)
    eng = _engine(tq, tcfg)
    pid = eng.register_prefix(prefix)
    got = _serve(eng, prompts=prompts, prefix_id=pid)
    for i in range(len(prompts)):
        assert got[i].error is None
        assert got[i].out_tokens == plain[i].out_tokens, i
    eng.submit(Request(id=7, prompt=[1, 2, 3], prefix_id=pid))
    eng.submit(Request(id=8, prompt=prefix, prefix_id=pid + 1))
    bad = {r.id: r.error for r in eng.run()}
    assert "prefix" in bad[7] and "prefix_id" in bad[8]
    eng.drop_prefix(pid)
    with pytest.raises(ValueError):
        eng.register_prefix([])


def test_engine_chunked_prefill(models):
    """prefill_chunk splits the long prompt over ticks (cached-prefix
    prefill of each chunk) and the tokens equal the unchunked engine."""
    _, _, tcfg, tq = models
    want = _serve(_engine(tq, tcfg))
    eng = _engine(tq, tcfg, prefill_chunk=4)
    got = _serve(eng)
    for i in range(len(PROMPTS)):
        assert got[i].out_tokens == want[i].out_tokens, i
    assert eng.stats()["prefill_dispatches"] > len(PROMPTS)


# --- the HTTP server ----------------------------------------------------------------

def test_server_round_trip(models):
    """EngineServer on port 0: concurrent /v1/generate requests answer with
    the engine's tokens, streaming yields the same tokens line by line,
    and /v1/stats, /health, /v1/cancel and bad requests answer."""
    _, _, tcfg, tq = models
    want = _serve(_engine(tq, tcfg), prompts=PROMPTS[:3], n_new=4)
    srv = EngineServer(_engine(tq, tcfg), port=0).start()
    base = f"http://127.0.0.1:{srv.port}"

    def call(path, obj=None):
        data = None if obj is None else json.dumps(obj).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + path, data=data), timeout=120) as r:
            return r.read()

    try:
        assert json.loads(call("/health")) == {"ok": True}
        outs = [None] * 3

        def hit(i):
            outs[i] = json.loads(call("/v1/generate", {
                "prompt": PROMPTS[i], "max_new_tokens": 4}))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
        [t.start() for t in threads]
        [t.join(timeout=120) for t in threads]
        for i, out in enumerate(outs):
            assert out["error"] is None, out
            assert out["tokens"] == want[i].out_tokens
        lines = [json.loads(ln) for ln in call("/v1/generate", {
            "prompt": PROMPTS[0], "max_new_tokens": 4,
            "stream": True}).splitlines() if ln]
        assert "id" in lines[0] and lines[-1]["done"] is True
        assert [ln["token"] for ln in lines[1:-1]] == want[0].out_tokens
        st = json.loads(call("/v1/stats"))
        assert st["tokens_emitted"] == 16 and "uptime_s" in st
        assert json.loads(call("/v1/cancel", {"id": 12345})) == \
            {"cancelled": False}
        for body in ({"text": "hello"}, {"prompt": "x"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                call("/v1/generate", body)
            assert e.value.code == 400
    finally:
        srv.stop()


# --- INT8 head-major engine: GPT-2 and TINY_LLAMA -------------------------------

def _float_models(name):
    """Float parameters of a tiny GPT-2 or TINY_LLAMA (f32, from numpy), in
    both packages."""
    from ggmlsharp_tpu.models import gpt2 as jgpt2
    from ggmlsharp_tpu_torch.models import gpt2

    if name == "gpt2":
        kw = dict(n_vocab=96, n_ctx=64, n_embd=64, n_head=4, n_layer=2)
        jmod, tmod, jcfg, tcfg = (jgpt2, gpt2, jgpt2.GPT2Config(**kw),
                                  gpt2.GPT2Config(**kw))
    else:
        jmod, tmod, jcfg, tcfg = (jllama, llama, jllama.TINY_LLAMA,
                                  llama.TINY_LLAMA)
    rng = np.random.default_rng(17)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.1
                   + (a == 1)).astype(np.float32),
        jmod.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    return (jmod, jcfg, jax.tree.map(jnp.asarray, tree), tmod, tcfg,
            tmod.params_from_jax(tree, device="cpu"))


@pytest.mark.parametrize("name", ["gpt2", "tiny_llama"])
def test_int8_engine_head_major_matches_jax_engine(name):
    """Engine(int8_kv=True) for a model without the flat cache (every
    GPT-2; TINY_LLAMA's E_kv of 64): a head-major INT8 cache of the JAX
    engine's shape and dtypes, and two requests answered token for token as
    the JAX engine answers them."""
    jmod, jcfg, jp, tmod, tcfg, tp = _float_models(name)
    jeng = JEngine(jmod.forward, jcfg, jp, batch_slots=2, int8_kv=True,
                   max_len=64)
    eng = Engine(tmod.forward, tcfg, tp, batch_slots=2, int8_kv=True,
                 max_len=64, device="cpu")
    assert eng.cache.int8 and not eng.cache.is_flat
    assert not jkvc.is_flat(jeng.cache)
    for got, want in ((eng.cache.k[0], jeng.cache.k[0]),
                      (eng.cache.k_scale[0], jeng.cache.k_scale[0])):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[1] == str(want.dtype)
    prompts = [[5, 17, 33, 2], [7, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11]]
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(id=i, prompt=list(p), max_new_tokens=N_NEW))
    jout = {r.id: r.out_tokens for r in jeng.run()}
    got = _serve(eng, prompts=prompts)
    for i in range(len(prompts)):
        assert got[i].error is None
        assert got[i].out_tokens == jout[i], i
