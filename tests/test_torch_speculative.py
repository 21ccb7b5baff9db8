"""The port's speculative decoding (models.speculative) against the JAX
package on the CPU: the counterparts of tests/test_speculative.py, one for
one, on its seeds, configs and prompts, plus ``_mod_probs`` against JAX's.

Parameters are the JAX tests' own (init_params from their PRNG keys),
carried across bit for bit (test_torch_llama.to_port_tree ->
params_from_jax). Greedy speculative tokens must equal both the port's own
greedy decode (sampling.generate) and the JAX reference tokens the JAX test
holds its speculative decode against, exactly: every model here is f32,
where the packages differ in summation order and libm ulps only (~1e-6 on
logits of magnitude ~1), and no top-2 gap on these prompts is that small,
so no token is undecided. The mean tokens a round must
equal JAX's too, which holds the draft's choices and the acceptance to
JAX's round by round.

Sampling draws from a torch.Generator, so a sampled stream is held by its
distribution and its degenerate cases (top_k = 1, temperature 0), not token
for token: the TV bar 0.12 and the 1500 draws are the JAX test's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import gptj as jgptj
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.models import speculative as jspec
from ggmlsharp_tpu_torch.models import gpt2, gptj, llama, sampling
from ggmlsharp_tpu_torch.models.common import params_from_jax
from ggmlsharp_tpu_torch.models.speculative import (
    _mod_probs, make_spec_round, make_spec_round_sampled,
    speculative_generate)
from test_torch_llama import to_port_tree

CFG = dict(n_vocab=128, n_ctx=128, n_embd=64, n_head=4, n_layer=2)
LCFG = dict(n_vocab=128, n_ctx=96, n_embd=256, n_head=4, n_head_kv=2,
            n_layer=2, n_ff=512)  # E_kv = 128: the flat cache is eligible
F32 = torch.float32


def _pair(jmod, mod, jcfg, cfg, tkey, dkey):
    """(target, draft) trees in both packages: JAX's init_params at the JAX
    test's keys, carried across bit for bit."""
    out = []
    for key in (tkey, dkey):
        jp = jmod.init_params(jax.random.PRNGKey(key), jcfg,
                              dtype=jnp.float32)
        out.append((jp, params_from_jax(to_port_tree(jp), device="cpu")))
    return out


@pytest.fixture(scope="module")
def g2():
    """The JAX tests' GPT-2 target (key 0) and independent draft (key 7)."""
    jcfg, cfg = jgpt2.GPT2Config(**CFG), gpt2.GPT2Config(**CFG)
    (jt, tt), (jd, td) = _pair(jgpt2, gpt2, jcfg, cfg, 0, 7)
    return jcfg, cfg, jt, tt, jd, td


def _cache(mod, cfg, batch=1, **kw):
    return mod.new_cache(cfg, batch, dtype=F32, device="cpu", **kw)


def _greedy(mod, cfg, params, prompt, n, **kw):
    """The port's own greedy decode."""
    toks, _ = sampling.generate(mod.forward, cfg, params,
                                torch.tensor(prompt, dtype=torch.int32),
                                _cache(mod, cfg, len(prompt), **kw), n)
    return toks.numpy()


def _jax_greedy(jmod, jcfg, jp, prompt, n, **kw):
    """The JAX test's reference: JAX's greedy decode."""
    kw.setdefault("dtype", jnp.float32)
    cache = jmod.new_cache(jcfg, len(prompt), **kw)
    toks, _ = jsampling.generate(jmod.forward, jcfg, jp,
                                 jnp.asarray(prompt, jnp.int32), cache, n)
    return np.asarray(toks)


def _spec(mod, cfg, tp, dp, prompt, n, k, tkw=None, dkw=None, **kw):
    toks, rate = speculative_generate(
        mod.forward, cfg, tp, mod.forward, cfg, dp,
        torch.tensor(prompt, dtype=torch.int32),
        _cache(mod, cfg, len(prompt), **(tkw or {})),
        _cache(mod, cfg, len(prompt), **(dkw or {})), n, k=k, **kw)
    return toks.numpy(), rate


def _jax_spec_rate(jmod, jcfg, jt, jd, prompt, n, k, **kw):
    kw.setdefault("dtype", jnp.float32)
    _, rate = jspec.speculative_generate(
        jmod.forward, jcfg, jt, jmod.forward, jcfg, jd,
        jnp.asarray(prompt, jnp.int32), jmod.new_cache(jcfg, len(prompt), **kw),
        jmod.new_cache(jcfg, len(prompt), **kw), n, k=k)
    return rate


@pytest.mark.parametrize("k", [1, 3, 4])
def test_spec_matches_greedy_gpt2(g2, k):
    jcfg, cfg, jt, tt, jd, td = g2
    prompt, n = [[5, 17, 99, 3, 42]], 24
    ref = _greedy(gpt2, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jgpt2, jcfg, jt, prompt, n))
    toks, rate = _spec(gpt2, cfg, tt, td, prompt, n, k)
    np.testing.assert_array_equal(toks, ref)
    assert 1.0 <= rate <= k + 1
    assert rate == _jax_spec_rate(jgpt2, jcfg, jt, jd, prompt, n, k)


def test_spec_all_accept_when_draft_is_target(g2):
    """draft == target: every draft accepted, k+1 emitted a round."""
    jcfg, cfg, jt, tt, _, _ = g2
    prompt, n, k = [[1, 2, 3]], 20, 4
    ref = _greedy(gpt2, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jgpt2, jcfg, jt, prompt, n))
    toks, rate = _spec(gpt2, cfg, tt, tt, prompt, n, k)
    np.testing.assert_array_equal(toks, ref)
    assert rate == pytest.approx(k + 1)


def test_spec_batched_slots(g2):
    """Two slots that part at once: per-slot accept counts differ, each
    slot's lengths roll back on their own."""
    jcfg, cfg, jt, tt, jd, td = g2
    prompt, n = [[5, 17, 99, 3], [100, 2, 64, 31]], 16
    ref = _greedy(gpt2, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jgpt2, jcfg, jt, prompt, n))
    toks, rate = _spec(gpt2, cfg, tt, td, prompt, n, 3)
    np.testing.assert_array_equal(toks, ref)
    assert rate == _jax_spec_rate(jgpt2, jcfg, jt, jd, prompt, n, 3)


def test_spec_single_token_prompt(g2):
    jcfg, cfg, jt, tt, jd, td = g2
    prompt, n = [[9]], 12
    ref = _greedy(gpt2, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jgpt2, jcfg, jt, prompt, n))
    toks, _ = _spec(gpt2, cfg, tt, td, prompt, n, 2)
    np.testing.assert_array_equal(toks, ref)


def test_spec_llama_flat_cache():
    """Llama over the default (head-major float) cache: single-token draft
    steps and the multi-token verify."""
    jcfg, cfg = jllama.TINY_LLAMA, llama.TINY_LLAMA
    (jt, tt), (jd, td) = _pair(jllama, llama, jcfg, cfg, 2, 3)
    prompt, n = [[4, 8, 15, 16, 23, 42]], 16
    ref = _greedy(llama, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jllama, jcfg, jt, prompt, n))
    toks, rate = _spec(llama, cfg, tt, td, prompt, n, 3)
    np.testing.assert_array_equal(toks, ref)
    assert rate == _jax_spec_rate(jllama, jcfg, jt, jd, prompt, n, 3)


def test_spec_cache_headroom_validated(g2):
    _, cfg, _, tt, _, td = g2
    with pytest.raises(ValueError, match="max_len"):
        _spec(gpt2, cfg, tt, td, [[1, 2]], 32, 4, tkw={"max_len": 16})
    with pytest.raises(ValueError, match="draft cache max_len"):
        _spec(gpt2, cfg, tt, td, [[1, 2]], 32, 4, dkw={"max_len": 16})


def test_spec_llama_flat_eligible_cache():
    """E_kv 128 with flat=True: the verify and the seed prefill attend the
    cache's live prefix (cached_prefix=True), not only their own K/V."""
    jcfg, cfg = jllama.LlamaConfig(**LCFG), llama.LlamaConfig(**LCFG)
    (jt, tt), (jd, td) = _pair(jllama, llama, jcfg, cfg, 4, 5)
    tc = _cache(llama, cfg, flat=True)
    assert tc.is_flat
    prompt, n = [[7, 3, 88, 11]], 16
    ref = _greedy(llama, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jllama, jcfg, jt, prompt, n))
    toks, rate = speculative_generate(
        llama.forward, cfg, tt, llama.forward, cfg, td,
        torch.tensor(prompt, dtype=torch.int32), tc, _cache(llama, cfg), n,
        k=3)
    np.testing.assert_array_equal(toks.numpy(), ref)
    assert 1.0 <= rate <= 4.0


def test_spec_llama_int8_kv_cache():
    """INT8 flat caches: the rounds re-quantize rows that a rollback left
    behind; the tokens equal plain greedy decode over the same INT8 target
    cache, and JAX's."""
    jcfg, cfg = jllama.LlamaConfig(**LCFG), llama.LlamaConfig(**LCFG)
    (jt, tt), (jd, td) = _pair(jllama, llama, jcfg, cfg, 4, 5)
    prompt, n = [[7, 3, 88, 11]], 12
    ref = _greedy(llama, cfg, tt, prompt, n, int8=True)
    jref, _ = jsampling.generate(jllama.forward, jcfg, jt,
                                 jnp.asarray(prompt, jnp.int32),
                                 jllama.new_cache(jcfg, 1, int8=True), n)
    np.testing.assert_array_equal(ref, np.asarray(jref))
    toks, _ = _spec(llama, cfg, tt, td, prompt, n, 3, tkw={"int8": True},
                    dkw={"int8": True})
    np.testing.assert_array_equal(toks, ref)


def test_sampled_spec_topk1_equals_greedy(g2):
    """top_k = 1 truncates both distributions to the one-hot argmax: the
    sampled round reproduces greedy decode for any temperature and
    generator."""
    jcfg, cfg, jt, tt, _, td = g2
    prompt, n = [[5, 17, 99]], 12
    ref = _greedy(gpt2, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jgpt2, jcfg, jt, prompt, n))
    toks, rate = _spec(gpt2, cfg, tt, td, prompt, n, 3, temperature=0.8,
                       top_k=1, rng=torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(toks, ref)
    assert 1.0 <= rate <= 4.0
    with pytest.raises(ValueError, match="rng"):
        _spec(gpt2, cfg, tt, td, prompt, n, 3, temperature=0.8)


def _round_inputs(params_t, params_d, cfg, prompt, max_len=None):
    """Both caches prefilled as speculative_generate leaves them (target:
    the prompt; draft: all but its last token) and the first seed."""
    B, S = len(prompt), len(prompt[0])
    kw = {} if max_len is None else {"max_len": max_len}
    tc, dc = _cache(gpt2, cfg, B, **kw), _cache(gpt2, cfg, B, **kw)
    toks = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    with torch.no_grad():
        lg, tc = gpt2.forward(params_t, cfg, toks, tc, pos)
        _, dc = gpt2.forward(params_d, cfg, toks[:, :-1], dc, pos[:, :-1])
    a0 = torch.argmax(lg[:, -1], -1).to(torch.int32)
    return tc, dc, torch.stack([toks[:, -1], a0], dim=1), a0


def test_sampled_spec_temp0_slots_degenerate_to_greedy(g2):
    """The sampled round at temperature 0 emits what the greedy round emits
    (one-hot distributions: acceptance is argmax match), and the greedy
    round emits JAX's greedy round's tokens."""
    jcfg, cfg, jt, tt, jd, td = g2
    k, B = 3, 2
    prompt = [[5, 17, 99, 2], [7, 1, 3, 4]]
    greedy = make_spec_round(gpt2.forward, cfg, gpt2.forward, cfg, k)
    sampled = make_spec_round_sampled(gpt2.forward, cfg, gpt2.forward, cfg, k)
    tc, dc, seed, _ = _round_inputs(tt, td, cfg, prompt)
    em_g, ne_g, tc_g, dc_g, seed_g = greedy(tt, td, tc, dc, seed)
    tc, dc, seed, _ = _round_inputs(tt, td, cfg, prompt)
    em_s, ne_s, tc_s, dc_s, seed_s = sampled(
        tt, td, tc, dc, seed, torch.Generator().manual_seed(0),
        torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B))
    assert ne_s.tolist() == ne_g.tolist()
    assert em_s.tolist() == em_g.tolist()
    assert seed_s.tolist() == seed_g.tolist()
    assert tc_s.length.tolist() == tc_g.length.tolist() \
        == (4 + ne_g).tolist()
    assert dc_s.length.tolist() == dc_g.length.tolist() \
        == (3 + ne_g).tolist()
    # JAX's greedy round on the same inputs
    jround = jspec.make_spec_round(jgpt2.forward, jcfg, jgpt2.forward, jcfg,
                                   k)
    jtc = jgpt2.new_cache(jcfg, B, dtype=jnp.float32)
    jdc = jgpt2.new_cache(jcfg, B, dtype=jnp.float32)
    jp_ = jnp.asarray(prompt, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(4, dtype=jnp.int32)[None], (B, 4))
    lg, jtc = jgpt2.forward(jt, jcfg, jp_, jtc, pos)
    _, jdc = jgpt2.forward(jd, jcfg, jp_[:, :3], jdc, pos[:, :3])
    a0 = jnp.argmax(lg[:, -1, :], -1).astype(jnp.int32)
    jem, jne, *_ = jround(jt, jd, jtc, jdc, jnp.stack([jp_[:, -1], a0], 1))
    assert np.asarray(jne).tolist() == ne_g.tolist()
    assert np.asarray(jem).tolist() == em_g.tolist()


def test_sampled_spec_preserves_target_distribution(g2):
    """Rejection-sampled speculative decoding emits the target's modified
    distribution: the FIRST emitted token of one round, over 1500
    independent draws, against the target's _mod_probs at that position
    (total variation < 0.12, the JAX test's bar). The draws are 1500 slots
    of one batched round (independent rows of one generator) in place of
    JAX's 1500 rounds under split keys."""
    jcfg, cfg, jt, tt, _, td = g2
    k, temp, nsamp = 2, 0.9, 1500
    prompt = [[5, 17, 99, 2]]
    tc, dc, seed, a0 = _round_inputs(tt, td, cfg, prompt * nsamp, max_len=16)
    # ground truth: the target's distribution of the token after a0
    one = torch.tensor([prompt[0] + [int(a0[0])]], dtype=torch.int32)
    with torch.no_grad():
        lg, _ = gpt2.forward(tt, cfg, one, _cache(gpt2, cfg),
                             torch.arange(5, dtype=torch.int32)[None])
    t1 = torch.full((1,), temp)
    want = _mod_probs(lg[:, -1], t1, torch.zeros(1, dtype=torch.int32),
                      torch.ones(1))[0].numpy()
    jlg, _ = jgpt2.forward(jt, jcfg, jnp.asarray(one.numpy()),
                           jgpt2.new_cache(jcfg, 1, dtype=jnp.float32),
                           jnp.arange(5, dtype=jnp.int32)[None])
    jwant = np.asarray(jspec._mod_probs(
        jlg[:, -1], jnp.full((1,), temp, jnp.float32),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.float32)))[0]
    np.testing.assert_allclose(want, jwant, rtol=0, atol=1e-6)

    rnd = make_spec_round_sampled(gpt2.forward, cfg, gpt2.forward, cfg, k)
    em, ne, *_ = rnd(tt, td, tc, dc, seed, torch.Generator().manual_seed(123),
                     torch.full((nsamp,), temp),
                     torch.zeros(nsamp, dtype=torch.int32),
                     torch.ones(nsamp))
    assert ((ne >= 1) & (ne <= k + 1)).all()
    counts = np.bincount(em[:, 0].numpy(), minlength=cfg.n_vocab) / nsamp
    tvd = 0.5 * np.abs(counts - want).sum()
    assert tvd < 0.12, tvd


def test_spec_gptj_family():
    """The GPT-J family (head-major cache, parallel-residual forward):
    greedy-exact against target-only decode, and JAX's tokens."""
    jcfg, cfg = jgptj.TINY_GPTJ, gptj.TINY_GPTJ
    (jt, tt), (jd, td) = _pair(jgptj, gptj, jcfg, cfg, 0, 9)
    prompt, n = [[5, 17, 99]], 10
    ref = _greedy(gptj, cfg, tt, prompt, n)
    np.testing.assert_array_equal(ref, _jax_greedy(jgptj, jcfg, jt, prompt, n))
    toks, rate = _spec(gptj, cfg, tt, td, prompt, n, 3)
    np.testing.assert_array_equal(toks, ref)
    assert 1.0 <= rate <= 4.0
    assert rate == _jax_spec_rate(jgptj, jcfg, jt, jd, prompt, n, 3)


@pytest.mark.parametrize("V", [128, 50257])
def test_mod_probs_matches_jax(V):
    """The per-slot sampling distribution against JAX's, at 1e-6: greedy
    (temperature 0) slots one-hot, top-k, nucleus top-p and both, a slot
    whose top_k is the vocabulary, and a top_k of 1."""
    rng = np.random.default_rng(V)
    logits = (rng.standard_normal((7, V)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.5, 0.9, 1.2, 0.7, 1.0, 0.8], np.float32)
    top_k = np.array([0, 5, 0, 3, 1, V, 40], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.8, 0.95, 0.3], np.float32)
    got = _mod_probs(*map(torch.from_numpy, (logits, temp, top_k, top_p)))
    want = np.asarray(jspec._mod_probs(*map(jnp.asarray,
                                            (logits, temp, top_k, top_p))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert got[0].max() == 1.0 and int(got[0].argmax()) == logits[0].argmax()
    assert int((got[4] > 0).sum()) == 1
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
