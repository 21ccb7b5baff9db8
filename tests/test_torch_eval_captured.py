"""The perplexity window in its captured form (eval/perplexity.py: one
CapturedStep a ``perplexity`` call, a window's tokens copied into its
static input) and ``ops.mul_mat_f`` in the operands' dtype, against the
JAX package on the CPU.

  * ``perplexity`` of a small GPT-2 over six windows (a stride under the
    window) against JAX's jitted chunk: the mean NLL and the perplexity to
    rtol 1e-5 (test_torch_eval.py's bar: f32 weights and cache, other
    summation orders), the scored count exactly; with torch.cuda's capture
    stubbed, one capture a call and one replay a window. One window's
    ``nll_chunk`` (GPT-2 and the small Llama) runs under the dispatch
    mode that refuses every read back to the host and every host copy;
    its control shows the mode firing.
  * ``mul_mat_f`` at bf16 and f16 against JAX's (a matmul in the operands'
    dtype with an f32 accumulator, cast to the promoted type): every output
    within 2^-8 of JAX's, relative, or one ulp of its dtype, plus the
    distance two f32 sums of the same K terms in other orders can part
    ((K - 1) 2^-24 sum|a b| each). Both round an f32 sum once, but the
    sums' orders differ: where a sum cancels (an output of 1.5e-4 from 256
    terms of ~0.2) they part by ~1e-6, and rounded apart a bf16 output can
    move by one ulp, up to 2^-7 relative (1 of 2040 outputs here in each
    dtype); outputs past 2^-8 relative stay under 1%. Mixed and f32
    operands take the f32 route, as before.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.eval import perplexity as jppl
from ggmlsharp_tpu.ops import mul_mat_f as jmul_mat_f
from ggmlsharp_tpu_torch.eval import perplexity
from ggmlsharp_tpu_torch.eval.perplexity import nll_chunk
from ggmlsharp_tpu_torch.models import captured
from ggmlsharp_tpu_torch.ops import mul_mat_f
from test_torch_adam_captured import _NoHostTraffic
from test_torch_adam_captured import stub_cuda  # noqa: F401 (a fixture)
from test_torch_eval import _models, _stream


@pytest.fixture(scope="module")
def gpt2_models():
    return _models("gpt2")


def test_perplexity_windows_match_jax(gpt2_models):
    jmod, tmod, jcfg, tcfg, jp, tp = gpt2_models
    stream = _stream(140, tcfg.n_vocab, seed=7)
    want = jppl(jmod.forward, jcfg, jp, stream, chunk_len=32, stride=20)
    got = perplexity(tmod.forward, tcfg, tp, stream, chunk_len=32, stride=20)
    assert got[2] == want[2] == 6 * 15
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


def test_perplexity_captures_once_and_replays_each_window(gpt2_models,
                                                          stub_cuda):
    _, tmod, _, tcfg, _, tp = gpt2_models
    captured.reset_counts()
    perplexity(tmod.forward, tcfg, tp, _stream(140, tcfg.n_vocab, seed=7),
               chunk_len=32, stride=20)
    assert (captured.COUNTS["captures"], captured.COUNTS["replays"]) == (1, 6)
    captured.reset_counts()


# nll_chunk's body outside its inference_mode: inside it the dispatch mode
# sees no op (inference tensors bypass Python dispatch)
_nll_body = nll_chunk.__wrapped__


@pytest.mark.parametrize("name", ["gpt2", "tiny_llama"])
def test_perplexity_window_makes_no_host_sync(name, gpt2_models):
    _, tmod, _, tcfg, _, tp = gpt2_models if name == "gpt2" \
        else _models(name)
    chunk = torch.from_numpy(_stream(32, tcfg.n_vocab, seed=8)[None])
    with torch.no_grad(), _NoHostTraffic():
        nll = _nll_body(tmod.forward, tcfg, tp, chunk)
    assert nll.shape == (1, 31) and bool(torch.isfinite(nll).all())
    torch.testing.assert_close(nll, nll_chunk(tmod.forward, tcfg, tp, chunk),
                               rtol=0, atol=0)


def test_a_host_sync_in_the_forward_fires_the_check(gpt2_models):
    """The control: a forward that reads its first logit back raises."""
    _, tmod, _, tcfg, _, tp = gpt2_models

    def synced(params, cfg, toks, cache, pos, **kw):
        logits, cache = tmod.forward(params, cfg, toks, cache, pos, **kw)
        return logits * float(logits[0, 0, 0] != 0), cache

    chunk = torch.from_numpy(_stream(32, tcfg.n_vocab, seed=8)[None])
    with pytest.raises(RuntimeError, match="host sync"), torch.no_grad(), \
            _NoHostTraffic():
        _nll_body(synced, tcfg, tp, chunk)


def _operands(dtype, rng, k=256, batch=(3, 17), n=40):
    a = rng.standard_normal((n, k)).astype(np.float32) * 0.2
    b = rng.standard_normal((*batch, k)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_mul_mat_f_in_the_operands_dtype_matches_jax(dtype):
    rng = np.random.default_rng(11)
    a, b = _operands(dtype, rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = mul_mat_f(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    want = jmul_mat_f(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt))
    assert got.dtype == tdt and str(want.dtype) == dtype
    assert got.shape == want.shape == (3, 17, 40)
    g = got.to(torch.float32).numpy()
    w = np.asarray(want.astype(jnp.float32))
    err = np.abs(g - w)
    # one ulp of the output's dtype at w (a rounding flip: 2^-7 of w's
    # binade in bf16, 2^-10 in f16) and how far two f32 sums of the same K
    # terms in other orders can part, (K - 1) 2^-24 sum|a b| each
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                  - (7 if dtype == "bfloat16" else 10))
    ar = torch.from_numpy(a).to(tdt).float().abs()
    br = torch.from_numpy(b).to(tdt).float().abs()
    orders = 2 * (a.shape[1] - 1) * 2.0 ** -24 * (br @ ar.t()).numpy()
    assert (err <= np.maximum(2.0 ** -8 * np.abs(w), ulp) + orders).all()
    assert (err > 2.0 ** -8 * np.abs(w)).mean() <= 0.01


def test_mul_mat_f_mixed_and_f32_operands_take_the_f32_route():
    rng = np.random.default_rng(12)
    a, b = _operands("float32", rng)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = mul_mat_f(ta.to(torch.bfloat16), tb)
    want = jmul_mat_f(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(mul_mat_f(ta, tb), torch.matmul(tb, ta.t()))
    assert jax.numpy.float32 == want.dtype
