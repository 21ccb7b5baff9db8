"""The engine's admission prefill as captured steps (serving.admission) on
the CPU, against the JAX engine's jitted admissions and the port's own
eager form.

On the card a single admission is one CUDA graph a (bucket, total, cached,
draft), with the slot, start row and length as device inputs, and a
grouped admission one a (bucket, G, draft), G padded to a power of two by
duplicates of a real row, as the JAX engine compiles them. On the CPU the
same CapturedSteps run eagerly through their static buffers. Per model (the
serving llama over its flat INT8 cache, weight-only, and the tiny GPT-2 of
test_torch_serving over a head-major f32 cache):

  * a group of 3 same-bucket prompts, padded to 4, leaves the JAX engine's
    cache rows, lengths and last logits, and no other slot is touched;
  * admissions through a registered prefix (start > 0) and in chunks leave
    the JAX engine's rows, lengths and last logits, at one graph key for
    three admissions into two slots;
  * the protocol's form equals the captured.disabled() form bit for bit;
  * both admission steps make no host sync;
  * the plain engine, admitting through them, gives the JAX engine's
    tokens.

Bars: logits and float rows at the model's bar of test_torch_serving (1e-4
weight-only llama; 2e-4 GPT-2 f32, test_torch_gpt2's); INT8 rows within one
quantization step and their scales within 1e-4 relative (a one-ulp
difference of a row can move one rounding by a step).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.serving import Engine as JEngine
from ggmlsharp_tpu.serving import Request as JRequest
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import captured, llama
from ggmlsharp_tpu_torch.serving import Engine, Request
from test_torch_lbfgs_jit import _NoHostSync
from test_torch_llama import CFG as LLAMA_CFG
from test_torch_llama import to_port_tree
from test_torch_serving import _float_models


@pytest.fixture(autouse=True)
def _exact(monkeypatch):
    """Both packages weight-only, the port's products and JAX's decode
    attention exact (mm_dot "f32")."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot("f32")
    monkeypatch.setattr(get_config(), "quantize_activations", False)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "0")
    yield
    jkcfg.set_mm_dot(prev)


@pytest.fixture(scope="module")
def cases():
    """name -> (JAX forward, cfg, params; port forward, cfg, params; engine
    keywords; bar)."""
    jcfg = jllama.LlamaConfig(**LLAMA_CFG)
    raw = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    jq = jllama.quantize_params(raw, JGType.Q4_0, swar=False)
    tq = llama.params_from_jax(to_port_tree(jq), device="cpu")
    jmod, gjcfg, gjp, tmod, gtcfg, gtp = _float_models("gpt2")
    return {
        "llama_flat_int8": (jllama.forward, jcfg, jq, llama.forward,
                            llama.LlamaConfig(**LLAMA_CFG), tq,
                            dict(int8_kv=True), 1e-4),
        "gpt2_f32": (jmod.forward, gjcfg, gjp, tmod.forward, gtcfg, gtp,
                     dict(int8_kv=False), 2e-4)}


def _engines(case, B, **kw):
    jfwd, jcfg, jp, tfwd, tcfg, tp, ekw, tol = case
    jeng = JEngine(jfwd, jcfg, jp, batch_slots=B, max_len=64, **ekw, **kw)
    eng = Engine(tfwd, tcfg, tp, batch_slots=B, max_len=64, device="cpu",
                 cache_dtype=torch.float32, **ekw, **kw)
    return jeng, eng, tol


def _bufs(c):
    return [*c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ())]


def _rows(x, slot, n, flat):
    x = np.asarray(x)[slot]
    return x[:n] if flat else x[:, :n]


def _hold(jeng, eng, slots_rows, tol):
    """Rows [0, n) of each (slot, n), the lengths and the slots' last
    logits of the port engine against the JAX engine's."""
    c, jc = eng.cache, jeng.cache
    np.testing.assert_array_equal(c.length.numpy(), np.asarray(jc.length))
    n_rows = len(c.k) + len(c.v)
    for i, (x, jx) in enumerate(zip(_bufs(c), _bufs(jc))):
        for slot, n in slots_rows:
            got = _rows(x.float().numpy(), slot, n, c.is_flat)
            want = _rows(np.asarray(jx, np.float32), slot, n, c.is_flat)
            if not c.int8:
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            elif i < n_rows:  # int8 rows: within one quantization step
                assert np.abs(got - want).max() <= 1
            else:  # their scales
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    for slot, _ in slots_rows:
        np.testing.assert_allclose(eng._last_logits[slot].numpy(),
                                   np.asarray(jeng._last_logits)[slot],
                                   rtol=0, atol=tol)


def _prompts(n_vocab, lens, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_vocab, n).tolist() for n in lens]


@pytest.mark.parametrize("name", ["llama_flat_int8", "gpt2_f32"])
def test_grouped_admission_matches_jax(cases, name):
    """3 same-bucket prompts into 4 slots: ONE forward of a group padded to
    4 rows (the last real row duplicated), one graph key (bucket 16, G 4);
    slot 3 stays untouched."""
    jeng, eng, tol = _engines(cases[name], 4)
    prompts = _prompts(eng.cfg.n_vocab, (3, 11, 5))
    for e, R in ((jeng, JRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            e.submit(R(id=i, prompt=p, max_new_tokens=4))
        e._admit()
    keys = list(eng._prefill_rows._graphs)
    assert keys == [(("G", 4), ("bucket", 16), ("draft", False))], keys
    assert not eng._prefill_one._graphs
    _hold(jeng, eng, [(0, 3), (1, 11), (2, 5)], tol)
    assert int(eng.cache.length[3]) == 0
    assert all(not bool(x[3].any()) for x in _bufs(eng.cache))
    assert not bool(eng._last_logits[3].any())


@pytest.mark.parametrize("name", ["llama_flat_int8", "gpt2_f32"])
def test_single_admissions_match_jax(cases, name):
    """Slot 0 through a registered prefix of 5 tokens (its 6-token suffix
    prefilled from row 5), slot 1 an 11-token prompt in chunks of 4 (rows
    0, 4, 8): the JAX engine's rows, lengths and last logits. The three
    admissions from a non-zero row share one graph key (bucket 16, total
    32, cached), whatever their slot."""
    jeng, eng, tol = _engines(cases[name], 2, prefill_chunk=4)
    pfx, long = _prompts(eng.cfg.n_vocab, (11, 11), seed=9)
    for e, R in ((jeng, JRequest), (eng, Request)):
        pid = e.register_prefix(pfx[:5])
        e.submit(R(id=0, prompt=pfx, max_new_tokens=4, prefix_id=pid))
        e.submit(R(id=1, prompt=long, max_new_tokens=4))
        e._admit()
        while e._chunking:
            e._advance_chunks()
    keys = sorted(eng._prefill_one._graphs, key=str)
    assert keys == [
        (("bucket", 16), ("cached", None), ("draft", False), ("total", 16)),
        (("bucket", 16), ("cached", True), ("draft", False), ("total", 32))]
    _hold(jeng, eng, [(0, 11), (1, 11)], tol)


def test_protocol_equals_eager_form(cases):
    """The same admissions (a group, a prefix, chunks) through the
    CapturedSteps' static buffers and in the captured.disabled() form:
    every cache buffer and the last logits bit-equal."""
    runs = []
    for eager in (False, True):
        _, eng, _ = _engines(cases["llama_flat_int8"], 4, prefill_chunk=8)
        pfx, *group = _prompts(eng.cfg.n_vocab, (12, 3, 5, 14), seed=2)
        pid = eng.register_prefix(pfx[:4])
        with captured.disabled() if eager else contextlib.nullcontext():
            eng.submit(Request(id=0, prompt=pfx, max_new_tokens=4,
                               prefix_id=pid))
            for i, p in enumerate(group):
                eng.submit(Request(id=1 + i, prompt=p, max_new_tokens=4))
            eng._admit()
            while eng._chunking:
                eng._advance_chunks()
        runs.append([t.clone() for t in (*_bufs(eng.cache), eng.cache.length,
                                         eng._last_logits)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_admission_steps_make_no_host_sync(cases):
    _, eng, _ = _engines(cases["llama_flat_int8"], 4)
    toks = torch.arange(16, dtype=torch.int32)[None]
    with torch.no_grad(), _NoHostSync():
        last = eng._prefill_one_body(
            toks, torch.tensor([2, 5, 9], dtype=torch.int32), bucket=16,
            total=32, cached=True, draft=False)
        rows = eng._prefill_rows_body(
            toks.expand(4, 16).contiguous(),
            torch.tensor([[0, 1, 3, 3], [4, 16, 7, 7], [0, 1, 2, 2]],
                         dtype=torch.int32), bucket=16, G=4, draft=False)
    assert last.shape == (1, eng.cfg.n_vocab)
    assert rows.shape == (4, eng.cfg.n_vocab)
    assert torch.equal(rows[2], rows[3])  # the pad row is its real row's
    assert eng.cache.length.tolist() == [4, 16, 14, 7]


@pytest.mark.parametrize("name", ["llama_flat_int8", "gpt2_f32"])
def test_plain_engine_gives_jax_engine_tokens(cases, name):
    """Six requests through 4 slots (a padded group, recycled slots, one
    through a prefix): the JAX engine's tokens."""
    jeng, eng, _ = _engines(cases[name], 4)
    prompts = _prompts(eng.cfg.n_vocab, (4, 9, 6, 13, 5, 7), seed=3)
    out = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        pid = e.register_prefix(prompts[5][:4])
        for i, p in enumerate(prompts):
            e.submit(R(id=i, prompt=p, max_new_tokens=6,
                       prefix_id=pid if i == 5 else None))
        out.append({r.id: r.out_tokens for r in e.run()})
    assert out[1] == out[0]
