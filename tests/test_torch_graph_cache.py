"""The graph cache (models.captured.entry: the port's counterpart of JAX's
jit cache with the cache donated) on the CPU, against the JAX package's
``generate``, ``make_decode_fns`` and greedy decode and against the port's
own eager form (captured.disabled(): no graph cache, the caller's cache
written directly).

On the CPU a CapturedStep runs its function eagerly through the same static
buffers its graph reads on the card, and the graph cache keeps the same
entries, home caches and static keys, so the tests count keys
(``captured.cache_info()``) where the card counts captures. Models: the
JAX package's TINY_LLAMA (head-major cache) and a 2-layer GPT-2 (flat
cache), both f32 and carried across bit for bit from JAX's init_params.
In f32 the packages differ in summation order and libm ulps only (~1e-6 on
logits of magnitude ~1; test_torch_speculative), so tokens must equal
JAX's exactly and the cache rows below the length agree within 2e-5 (the
f32 bar of test_torch_captured_decode); against the port's eager form
everything is bit-equal.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu_torch.models import captured, gpt2, llama, sampling
from ggmlsharp_tpu_torch.models.common import params_from_jax
from ggmlsharp_tpu_torch.models.speculative import speculative_generate
from test_torch_llama import to_port_tree

F32 = torch.float32
N_NEW = 6
ROW_TOL = 2e-5
G2 = dict(n_vocab=128, n_ctx=128, n_embd=64, n_head=4, n_layer=2)


def _models(name, key=0):
    """(JAX module, cfg, tree; port module, cfg, tree), f32."""
    if name == "llama":
        jmod, mod = jllama, llama
        jcfg, cfg = jllama.TINY_LLAMA, llama.TINY_LLAMA
    else:
        jmod, mod = jgpt2, gpt2
        jcfg, cfg = jgpt2.GPT2Config(**G2), gpt2.GPT2Config(**G2)
    jp = jmod.init_params(jax.random.PRNGKey(key), jcfg, dtype=jnp.float32)
    return jmod, jcfg, jp, mod, cfg, params_from_jax(to_port_tree(jp),
                                                     device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _models(name) for name in ("llama", "gpt2")}


@pytest.fixture(autouse=True)
def _fresh_cache():
    captured.clear()
    yield
    captured.clear()


def _prompt(n_vocab, n, seed):
    return np.random.default_rng(seed).integers(0, n_vocab, (1, n)).astype(
        np.int32)


def _cache(mod, cfg, **kw):
    return mod.new_cache(cfg, 1, dtype=F32, device="cpu", **kw)


def _live(cache, n):
    """Every K/V buffer's rows [0, n), as numpy (either layout)."""
    dim = 1 if cache.k[0].ndim == 3 else 2
    return [np.asarray(x).take(range(n), axis=dim)
            for x in (*cache.k, *cache.v)]


def _jax_live(jc, n):
    """A JAX cache's K/V rows [0, n) in the port's lane order: JAX's flat
    GPT-2 cache holds its rows in the wire order of its whole-block kernel
    (jgpt2._wire_perm), the port's in element order."""
    rows = _live(jc, n)
    if jc.k[0].ndim == 3:
        inv = jgpt2._wire_perm(jc.k[0].shape[-1])[1]
        rows = [r[..., inv] for r in rows]
    return rows


def _generate(mod, cfg, p, prompt, cache=None):
    cache = _cache(mod, cfg) if cache is None else cache
    toks, out = sampling.generate(mod.forward, cfg, p,
                                  torch.from_numpy(prompt), cache, N_NEW)
    assert out is cache
    return toks.numpy(), cache


def _assert_same_cache(a, b, n):
    assert torch.equal(a.length, b.length)
    for x, y in zip(_live(a, n), _live(b, n)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_repeated_generate_matches_jax_and_adds_no_key(models, name):
    """Two generate calls with fresh caches of one spec, the second with a
    shorter prompt (so the reused home cache holds the first call's rows
    past its length): tokens equal JAX's generate, the live rows agree with
    JAX's cache, both equal the eager form bit for bit, and the second call
    adds no entry and no static key."""
    jmod, jcfg, jp, mod, cfg, p = models[name]
    for i, n in enumerate((12, 7)):
        prompt = _prompt(cfg.n_vocab, n, seed=n)
        jtoks, jc = jsampling.generate(
            jmod.forward, jcfg, jp, jnp.asarray(prompt),
            jmod.new_cache(jcfg, 1, dtype=jnp.float32), N_NEW)
        toks, cache = _generate(mod, cfg, p, prompt)
        info = captured.cache_info()
        live = n + N_NEW  # the prompt and every sampled token
        assert int(cache.length[0]) == live
        np.testing.assert_array_equal(toks, np.asarray(jtoks))
        for x, y in zip(_live(cache, live), _jax_live(jc, live)):
            np.testing.assert_allclose(x, y, rtol=0, atol=ROW_TOL)
        with captured.disabled():
            etoks, ecache = _generate(mod, cfg, p, prompt)
        np.testing.assert_array_equal(toks, etoks)
        _assert_same_cache(cache, ecache, live)
        assert captured.cache_info() == info  # the eager form adds nothing
        if i == 0:
            first = info
            assert first["entries"] == 1 and first["keys"] == 2
    assert info["entries"] == first["entries"]
    # the new prompt length is one more prefill key, nothing else
    assert info["keys"] == first["keys"] + 1


def test_prefill_twice_adds_no_key_and_matches_jax(models):
    """make_decode_fns' prefill through the graph cache: JAX's last logits,
    the caller's cache written in place and returned, a second fresh cache
    of the spec adds no key."""
    jmod, jcfg, jp, mod, cfg, p = models["llama"]
    prompt = _prompt(cfg.n_vocab, 9, seed=4)
    jpre, _ = jsampling.make_decode_fns(jmod.forward, jcfg)
    jlg, _ = jpre(jp, jnp.asarray(prompt),
                  jmod.new_cache(jcfg, 1, dtype=jnp.float32), t_eff=128)
    prefill, _ = sampling.make_decode_fns(mod.forward, cfg)
    infos, rows = [], []
    for _ in range(2):
        cache = _cache(mod, cfg)
        lg, out = prefill(p, torch.from_numpy(prompt), cache, t_eff=128)
        assert out is cache and int(cache.length[0]) == 9
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=ROW_TOL)
        infos.append(captured.cache_info())
        rows.append(_live(cache, 9))
    assert infos[0] == infos[1] and infos[0]["keys"] == 1
    for x, y in zip(*rows):
        np.testing.assert_array_equal(x, y)


def test_interleaved_caches_do_not_alias(models):
    """Two caches of one spec, two prompts: a prefill on each, then a step
    on each in turn, then a generate on each: every caller's rows are its
    own prompt's (the eager form's, bit for bit), and no caller's buffer is
    the home cache's."""
    _, _, _, mod, cfg, p = models["gpt2"]
    prompts = [_prompt(cfg.n_vocab, n, seed=n) for n in (10, 6)]
    prefill, step = sampling.make_decode_fns(mod.forward, cfg)

    def run():
        caches = [_cache(mod, cfg) for _ in prompts]
        lgs = [prefill(p, torch.from_numpy(pr), c, t_eff=128)[0]
               for pr, c in zip(prompts, caches)]
        for lg, c in zip(lgs, caches):
            step(p, lg.argmax(-1, keepdim=True).to(torch.int32), c,
                 t_eff=128)
        toks = [_generate(mod, cfg, p, pr, c)[0]
                for pr, c in zip(prompts, caches)]
        return caches, toks

    caches, toks = run()
    with captured.disabled():
        ecaches, etoks = run()
    for c, e, t, et, pr in zip(caches, ecaches, toks, etoks, prompts):
        np.testing.assert_array_equal(t, et)
        n = int(c.length[0])
        assert n == 2 * pr.shape[1] + 1 + N_NEW
        _assert_same_cache(c, e, n)
    homes = {t.data_ptr() for held in captured._REGISTRY.values()
             for en in held.entries.values() for h in en.homes
             for t in captured.buffers(h)}
    mine = {t.data_ptr() for c in caches for t in captured.buffers(c)}
    assert homes and not homes & mine
    assert captured.cache_info()["entries"] == 1


def test_replaced_leaf_makes_a_new_entry(models):
    """A leaf replaced in place in the same tree object (a dense one, then
    a Q4_0 plane) keys another entry, whose graphs read the new leaf: the
    tokens are the eager form's of the changed tree."""
    _, _, _, mod, cfg, p = models["llama"]
    p = {**p, "blocks": [dict(b) for b in p["blocks"]]}
    prompt = _prompt(cfg.n_vocab, 8, seed=1)
    _generate(mod, cfg, p, prompt)
    assert captured.cache_info()["trees"] == 1
    p["blocks"][0]["wq"] = p["blocks"][0]["wq"] * 1.5
    toks, _ = _generate(mod, cfg, p, prompt)
    assert captured.cache_info()["trees"] == 2
    with captured.disabled():
        etoks, _ = _generate(mod, cfg, p, prompt)
    np.testing.assert_array_equal(toks, etoks)

    captured.clear()
    qcfg = llama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4,
                             n_head_kv=4, n_layer=1, n_ff=512)
    q = llama.synthetic_q4_0_params(qcfg, seed=1, device="cpu")
    _generate(llama, qcfg, q, prompt)
    w = q["blocks"][0]["wo"]
    w.planes["d"] = w.planes["d"].clone()  # same values, a new address
    _generate(llama, qcfg, q, prompt)
    assert captured.cache_info()["trees"] == 2


def test_settings_key_an_entry(models, monkeypatch):
    """A switch the forward reads while it is traced (the Q8 activation
    round trip) keys another entry of the same tree and spec."""
    _, _, _, mod, cfg, p = models["gpt2"]
    prompt = _prompt(cfg.n_vocab, 5, seed=2)
    _generate(mod, cfg, p, prompt)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "0")
    _generate(mod, cfg, p, prompt)
    info = captured.cache_info()
    assert info["trees"] == 1 and info["entries"] == 2


def test_speculative_generate_twice_matches_greedy_and_jax(models):
    """Greedy speculative decode through the graph cache, twice with fresh
    caches (GPT-2 target, an independent draft, k = 3): the target's own
    greedy tokens and JAX's, the second call adding no key; the returned
    caches equal the eager form's below their lengths."""
    jmod, jcfg, jt, mod, cfg, tt = models["gpt2"]
    *_, td = _models("gpt2", key=7)
    prompt, n, k = _prompt(cfg.n_vocab, 5, seed=5), 12, 3
    jref, _ = jsampling.generate(jmod.forward, jcfg, jt, jnp.asarray(prompt),
                                 jmod.new_cache(jcfg, 1, dtype=jnp.float32),
                                 n)
    ref, _ = _generate(mod, cfg, tt, prompt)
    np.testing.assert_array_equal(ref, np.asarray(jref)[:, :N_NEW])

    def run():
        tc, dc = _cache(mod, cfg), _cache(mod, cfg)
        toks, rate = speculative_generate(
            mod.forward, cfg, tt, mod.forward, cfg, td,
            torch.from_numpy(prompt), tc, dc, n, k=k)
        return toks.numpy(), rate, tc, dc

    infos = []
    for _ in range(2):
        toks, rate, tc, dc = run()
        np.testing.assert_array_equal(toks, np.asarray(jref))
        assert 1.0 <= rate <= k + 1
        infos.append(captured.cache_info())
    assert infos[0]["entries"] == infos[1]["entries"]
    assert infos[0]["keys"] == infos[1]["keys"]
    with captured.disabled():
        etoks, erate, etc, edc = run()
    np.testing.assert_array_equal(toks, etoks)
    assert rate == erate
    for c, e in ((tc, etc), (dc, edc)):
        _assert_same_cache(c, e, int(e.length.max()))


def test_sampled_generate_leaves_the_generator_as_eager():
    """A sampled generate draws outside the graphs, from the step's logits
    buffer: the same tokens and the same generator state after the call as
    the eager form from the same seed."""
    cfg = gpt2.GPT2Config(**G2)
    p = gpt2.init_params(cfg, device="cpu", dtype=F32)
    prompt = torch.from_numpy(_prompt(cfg.n_vocab, 6, seed=3))
    out = []
    for eager in (False, True):
        gen = torch.Generator().manual_seed(11)
        with captured.disabled() if eager else _null():
            toks, _ = sampling.generate(gpt2.forward, cfg, p, prompt,
                                        _cache(gpt2, cfg), N_NEW,
                                        temperature=0.9, top_k=20, rng=gen)
        out.append((toks, gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_sampled_speculative_copies_the_generator_state():
    """A sampled speculative call draws from the entry's own generator, its
    state copied in from the caller's and back: the eager form's tokens and
    generator state, and a second call adds no key."""
    cfg = gpt2.GPT2Config(**G2)
    p = gpt2.init_params(cfg, device="cpu", dtype=F32)
    prompt = torch.from_numpy(_prompt(cfg.n_vocab, 6, seed=8))
    out = []
    for eager in (False, False, True):
        gen = torch.Generator().manual_seed(3)
        with captured.disabled() if eager else _null():
            toks, rate = speculative_generate(
                gpt2.forward, cfg, p, gpt2.forward, cfg, p, prompt,
                _cache(gpt2, cfg), _cache(gpt2, cfg), 10, k=2,
                temperature=0.8, top_p=0.9, rng=gen)
        out.append((toks, rate, gen.get_state(), captured.cache_info()))
    for got in out[1:]:
        assert torch.equal(got[0], out[0][0]) and got[1] == out[0][1]
        assert torch.equal(got[2], out[0][2])
    assert out[1][3] == out[0][3]


def _null():
    import contextlib

    return contextlib.nullcontext()


def _home_ref():
    """A weak reference to a tensor of the graph cache's newest home cache."""
    held = next(reversed(captured._REGISTRY.values()))
    return weakref.ref(next(reversed(held.entries.values())).homes[0].k[0])


def test_clear_and_the_bounds_free_entries(monkeypatch):
    """MAX_TREES trees at most, least recently used out, each with
    MAX_ENTRIES entries at most; an evicted entry's home cache is freed,
    and clear() frees all."""
    assert (captured.MAX_TREES, captured.MAX_ENTRIES) == (2, 2)
    cfg = gpt2.GPT2Config(**G2)
    trees = [gpt2.init_params(cfg, torch.Generator().manual_seed(s),
                              device="cpu", dtype=F32) for s in range(3)]
    prompt = _prompt(cfg.n_vocab, 4, seed=0)
    refs = []
    for p in trees[:2]:
        _generate(gpt2, cfg, p, prompt)
        refs.append(_home_ref())
    _generate(gpt2, cfg, trees[0], prompt)  # tree 0 the most recent
    _generate(gpt2, cfg, trees[2], prompt)  # evicts tree 1
    gc.collect()
    assert captured.cache_info()["trees"] == 2
    assert refs[1]() is None and refs[0]() is not None
    for T in (32, 48, 64):  # three specs of one tree: two entries kept
        _generate(gpt2, cfg, trees[2], prompt,
                  _cache(gpt2, cfg, max_len=T))
    assert captured.cache_info()["entries"] == 1 + 2
    ref = _home_ref()
    captured.clear()
    gc.collect()
    assert captured.cache_info() == {"trees": 0, "entries": 0, "keys": 0,
                                     "home_bytes": 0}
    assert refs[0]() is None and ref() is None


def test_dropped_step_graphs_are_freed_without_a_collection(models):
    """make_decode_fns' step holds its CapturedStep in no reference cycle:
    dropped, it goes at once, not at a later collection (which could fall
    inside another capture, where CUDA refuses to destroy a graph)."""
    import gc

    _, _, _, mod, cfg, p = models["gpt2"]
    _, step = sampling.make_decode_fns(mod.forward, cfg)
    cache = _cache(mod, cfg)
    with torch.inference_mode():
        step(p, torch.zeros((1, 1), dtype=torch.int32), cache, t_eff=128)
    (held,) = [c.cell_contents for c in step.__closure__
               if isinstance(c.cell_contents, sampling._StepGraphs)]
    ref = weakref.ref(held._held._held[2])  # the CapturedStep
    gc.disable()
    try:
        del step, held
        assert ref() is None
    finally:
        gc.enable()
