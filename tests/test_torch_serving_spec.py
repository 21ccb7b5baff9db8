"""The port's speculative serving (Engine(draft_forward=...), serving.spec)
on the CPU: the counterparts of the speculative tests of
tests/test_serving.py, on their config, seeds and prompts.

The JAX tests' GPT-2 (init_params at key 0, the independent draft at key
7, f32) is carried across bit for bit. A speculative engine's greedy tokens
must equal the port's plain engine's and the port's sequential greedy
decode exactly (f32 throughout: the routes differ in summation order only,
and no top-2 gap on these prompts is that small); the first test also holds
them against JAX's sequential greedy decode, the reference of the JAX
tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu_torch.models import gpt2, sampling
from ggmlsharp_tpu_torch.models.common import params_from_jax
from ggmlsharp_tpu_torch.serving import Engine, Request
from test_torch_llama import to_port_tree

CFG = dict(n_vocab=128, n_ctx=96, n_embd=64, n_head=4, n_layer=2)
TCFG = gpt2.GPT2Config(**CFG)


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt2.GPT2Config(**CFG)
    jp = jgpt2.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jd = jgpt2.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    return (jcfg, jp, params_from_jax(to_port_tree(jp), device="cpu"),
            params_from_jax(to_port_tree(jd), device="cpu"))


def _sequential_greedy(params, prompt, n):
    cache = gpt2.new_cache(TCFG, 1, dtype=torch.float32, device="cpu")
    toks, _ = sampling.generate(gpt2.forward, TCFG, params,
                                torch.tensor([prompt], dtype=torch.int32),
                                cache, n)
    return toks[0].tolist()


def _engine(params, draft=None, **kw):
    if draft is not None:
        kw.update(draft_forward=gpt2.forward, draft_cfg=TCFG,
                  draft_params=draft)
    kw.setdefault("batch_slots", 2)
    return Engine(gpt2.forward, TCFG, params, device="cpu", **kw)


def _serve(eng, prompts, n_new, **req_kw):
    for i, p in enumerate(prompts):
        eng.submit(Request(id=i, prompt=list(p), max_new_tokens=n_new,
                           **req_kw))
    return eng.run()


def test_spec_engine_matches_plain_engine(models):
    """Speculative continuous batching emits the plain engine's greedy
    tokens across slot recycling and uneven prompt lengths, and JAX's
    sequential greedy tokens."""
    jcfg, jp, params, draft = models
    prompts = [[5, 17, 99], [7, 1, 2, 3, 4, 5, 6, 8], [11], [3, 3, 3, 3],
               [42, 42]]
    n_new = 7
    got = _serve(_engine(params, draft, spec_k=3), prompts, n_new)
    want = _serve(_engine(params), prompts, n_new)
    assert len(got) == len(want) == len(prompts)
    for g, w, p in zip(got, want, prompts):
        assert g.error is None
        assert g.out_tokens == w.out_tokens, (g.id, g.out_tokens,
                                              w.out_tokens)
        jtoks, _ = jsampling.generate(
            jgpt2.forward, jcfg, jp, jnp.asarray([p], jnp.int32),
            jgpt2.new_cache(jcfg, 1, dtype=jnp.float32), n_new)
        assert g.out_tokens == np.asarray(jtoks)[0].tolist(), g.id


def test_spec_engine_draft_is_target_all_accept(models):
    """draft == target: the greedy sequence, k+1 tokens every round (16
    tokens: a0 from the prefill, then three rounds of 5)."""
    _, _, params, _ = models
    eng = _engine(params, params, spec_k=4)
    got = _serve(eng, [[5, 17, 99]], 16)[0]
    assert got.out_tokens == _sequential_greedy(params, [5, 17, 99], 16)
    assert eng.stats()["decode_forwards"] == 3


def test_spec_engine_eos_and_validation(models):
    """repeat_penalty is refused in spec mode; an eos inside a round's
    emitted tokens cuts the request there."""
    _, _, params, draft = models
    eng = _engine(params, draft, spec_k=3)
    eng.submit(Request(id=0, prompt=[1, 2], max_new_tokens=4,
                       repeat_penalty=1.3))
    seq = _serve(_engine(params, batch_slots=1), [[5, 17, 99]], 8)[0] \
        .out_tokens
    eos = seq[3]
    eng.submit(Request(id=1, prompt=[5, 17, 99], max_new_tokens=8,
                       eos_id=eos))
    eng.submit(Request(id=2, prompt=[1, 2], max_new_tokens=4,
                       want_logprobs=True))
    got = eng.run()
    assert "repeat_penalty" in got[0].error and not got[0].out_tokens
    assert "want_logprobs" in got[2].error
    want = seq[:seq.index(eos) + 1]
    assert got[1].out_tokens == want, (got[1].out_tokens, want)


def test_spec_engine_with_prefix_caching(models):
    """Spec mode with a registered prefix: both models' rows installed, the
    suffix alone prefilled (the draft one token behind); the tokens are the
    plain engine's on the full prompts, prompt == prefix included."""
    _, _, params, draft = models
    prefix = [9, 42, 17, 5, 60]
    prompts = [prefix + s for s in ([7, 1, 2], [100], [], [55, 44])]
    n_new = 6
    eng = _engine(params, draft, spec_k=3)
    pid = eng.register_prefix(prefix)
    assert eng._prefixes[pid]["d"] is not None
    got = _serve(eng, prompts, n_new, prefix_id=pid)
    want = _serve(_engine(params), prompts, n_new)
    for g, w in zip(got, want):
        assert g.error is None
        assert g.out_tokens == w.out_tokens, (g.id, g.out_tokens,
                                              w.out_tokens)


def test_spec_prefix_suffix_near_max_len(models):
    """A suffix prefill over an installed prefix near max_len, for the
    target and the draft: the spec headroom caps max_new at
    max_len - plen - k - 2 = 3 here."""
    _, _, params, draft = models
    prefix = list(range(1, 21))
    prompt = prefix + [7, 3, 9, 1, 4]
    want = _sequential_greedy(params, prompt, 4)
    eng = _engine(params, draft, max_len=32, spec_k=2)
    pid = eng.register_prefix(prefix)
    eng.submit(Request(id=0, prompt=prompt, max_new_tokens=4, prefix_id=pid))
    got = eng.run()[0]
    assert got.error is None
    assert got.out_tokens == want[:3], (got.out_tokens, want)


def test_spec_engine_rejects_prompts_without_headroom(models):
    """A prompt that leaves no room for a round's k+1 rows is refused; the
    next request still runs."""
    _, _, params, draft = models
    eng = _engine(params, draft, max_len=32, spec_k=4)
    eng.submit(Request(id=0, prompt=list(range(1, 27)), max_new_tokens=4))
    eng.submit(Request(id=1, prompt=[5, 17, 99], max_new_tokens=3))
    got = eng.run()
    assert "headroom" in got[0].error and not got[0].out_tokens
    assert got[1].out_tokens == _sequential_greedy(params, [5, 17, 99], 3)


def test_spec_batched_admission_prefills_both_models(models):
    """A speculative admission burst rides ONE grouped prefill for each
    model (the target's prompts, the draft's prompts[:-1]) and stays
    greedy-exact. The JAX test counts compiled executables; eager PyTorch
    compiles none, so the grouped prefills themselves are counted."""
    _, _, params, draft = models
    prompts = [[5, 17, 99], [7, 1, 2], [11, 4], [3, 3, 3, 3]]
    eng = _engine(params, draft, batch_slots=4, spec_k=3)
    calls = []
    many = eng._prefill_many

    def spy(bucket, grp, tokens_of, draft=False):
        calls.append((len(grp), draft))
        return many(bucket, grp, tokens_of, draft)

    eng._prefill_many = spy
    got = _serve(eng, prompts, 6)
    assert calls == [(4, False), (4, True)], calls
    for i, req in enumerate(sorted(got, key=lambda r: r.id)):
        assert req.out_tokens == _sequential_greedy(params, prompts[i], 6)


def test_spec_engine_sampled_requests(models):
    """top_k = 1 forces the greedy sequence (any generator); greedy and
    truly sampled slots share the rejection-sampled round and the greedy
    ones stay exact."""
    _, _, params, draft = models
    n_new = 6
    eng = _engine(params, draft, spec_k=3, rng_seed=42)
    eng.submit(Request(id=0, prompt=[5, 17, 99], max_new_tokens=n_new,
                       temperature=0.9, top_k=1))
    eng.submit(Request(id=1, prompt=[7, 1], max_new_tokens=n_new))
    eng.submit(Request(id=2, prompt=[9, 4], max_new_tokens=n_new,
                       temperature=1.2, top_p=0.9))
    got = {r.id: r for r in eng.run()}
    assert got[0].error is None
    assert got[0].out_tokens == _sequential_greedy(params, [5, 17, 99], n_new)
    assert got[1].error is None
    assert got[1].out_tokens == _sequential_greedy(params, [7, 1], n_new)
    assert got[2].error is None and len(got[2].out_tokens) == n_new
    assert all(0 <= t < TCFG.n_vocab for t in got[2].out_tokens)


def test_spec_stop_sequences(models):
    """A multi-token stop sequence ends the request at the matching suffix
    in the speculative engine, as in the plain one."""
    _, _, params, draft = models
    base = _sequential_greedy(params, [5, 17, 99], 8)
    stop = [base[2], base[3]]

    def cut(seq, stops):  # the output truncated at the first suffix hit
        out = []
        for t in seq:
            out.append(t)
            if any(len(out) >= len(x) and out[-len(x):] == x for x in stops):
                return out
        return out

    want = cut(base, [stop])
    assert len(want) < len(base)  # the stop fires
    got_plain = _serve(_engine(params, batch_slots=1), [[5, 17, 99]], 8,
                       stop=[stop])[0].out_tokens
    got = _serve(_engine(params, draft, batch_slots=1, spec_k=3),
                 [[5, 17, 99]], 8, stop=[stop])[0].out_tokens
    assert got_plain == want, (got_plain, want)
    assert got == want, (got, want)


def test_spec_sampled_with_prefix_caching(models):
    """Sampled spec requests over a registered prefix: top_k = 1 collapses to
    greedy, so the tokens are the sequential greedy ones, prompt == prefix
    included."""
    _, _, params, draft = models
    prefix = [9, 42, 17, 5, 60]
    prompts = [prefix + [7, 1], prefix, prefix + [3]]
    eng = _engine(params, draft, spec_k=2)
    pid = eng.register_prefix(prefix)
    got = {r.id: r for r in _serve(eng, prompts, 5, prefix_id=pid,
                                   temperature=0.9, top_k=1)}
    for i, p in enumerate(prompts):
        assert got[i].error is None, got[i].error
        assert got[i].out_tokens == _sequential_greedy(params, p, 5), i


def test_spec_chunked_prefill(models):
    """prefill_chunk in spec mode: long prompts chunk (the target, then the
    draft) while the other slot keeps speculating; the tokens equal the
    unchunked spec engine's and plain greedy; both lengths are re-pinned
    when the last chunk lands."""
    _, _, params, draft = models
    prompts = [[(i % 90) + 1 for i in range(13)], [5, 17],
               [(i % 70) + 3 for i in range(9)]]

    def run(chunk):
        eng = _engine(params, draft, spec_k=3, prefill_chunk=chunk)
        out = {r.id: r.out_tokens for r in _serve(eng, prompts, 5)}
        assert not eng._spec_chunking
        return out

    want = run(None)
    got = run(4)
    assert got == want, (got, want)
    for i, p in enumerate(prompts):
        assert want[i] == _sequential_greedy(params, p, 5), i


def test_idle_slot_lengths_stay_inside_the_cache(models):
    """Every slot runs each round, an idle one too, and its length drifts
    by 1..k+1 a round: the round clamps both caches' lengths so that the
    next round's in-place writes stay inside the slot's own rows (a flat
    index past T would land in the next slot's)."""
    _, _, params, _ = models
    eng = _engine(params, params, max_len=48, spec_k=4)
    seen = []
    rnd = eng._spec_round

    def spy(*a, **kw):
        out = rnd(*a, **kw)
        seen.append((int(out[2].length.max()), int(out[3].length.max())))
        return out

    eng._spec_round = spy
    n = 48 - 3 - 4 - 2  # the spec headroom cap
    got = _serve(eng, [[5, 17, 99]], n)[0]
    assert got.out_tokens == _sequential_greedy(params, [5, 17, 99], n)
    assert len(seen) >= 7
    assert max(t for t, _ in seen) <= 48 - 5
    assert max(d for _, d in seen) <= 48 - 5
