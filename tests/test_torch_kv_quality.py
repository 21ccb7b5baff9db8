"""The port's decode-path KV-quality scoring (ggmlsharp_tpu_torch/eval/
kv_quality.py, the functions of scripts/kv_quality_torch.py) against the
JAX script's run() logic (scripts/kv_quality.py:71-103): 4 chunks x 16
teacher-forced single-token steps through an f32 head-major cache, a bf16
flat one and an int8 flat one, at E_kv 128 (4 heads of 32) and 192 (6 heads
of 32, the chain model's head dim and width), random f32 weights drawn by
JAX and carried across.

Both packages run decode attention in mm_dot "f32" (JAX's Pallas kernel in
interpret mode). Tolerances: decode ppl 1e-5 relative over the f32 cache
(f32 summation order); 1e-4 over the bf16 and int8 caches (the same rows
rounded, but a row whose f32 value differs by an ulp may round to the
neighbouring bf16 or int8 step). Argmax agreement with the f32 reference:
within one position of 64 of JAX's, and each step's argmax equal to JAX's
wherever JAX's top two logits are 1e-3 apart or more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.models import kv_cache as jkvc
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu_torch.eval import kv_quality
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import llama
from ggmlsharp_tpu_torch.models.common import params_from_jax

B, T = 4, 17  # 16 steps a chunk
STEPS = T - 1
JCACHES = [jnp.float32, jnp.bfloat16, jnp.bfloat16]


@pytest.fixture(autouse=True)
def _mm_dot_f32(monkeypatch):
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot("f32")
    yield
    jkcfg.set_mm_dot(prev)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run small ops in Python loops, where
    more threads only spin, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wire(x):
    return None if x is None else (
        {k: _wire(v) for k, v in x.items()} if isinstance(x, dict) else
        [_wire(v) for v in x] if isinstance(x, list) else np.asarray(x))


def _jax_run(jcfg, jp, X, Y, dtype, int8, flat):
    """scripts/kv_quality.py's run(): the jitted step over a fresh cache."""
    cache = jkvc.init_cache(jcfg.n_layer, B, jcfg.n_head_kv, T, jcfg.head_dim,
                            dtype=dtype, int8=int8, flat=flat)

    @jax.jit
    def step(params, tok, cache, pos):
        logits, cache = jllama.forward(params, jcfg, tok, cache, pos[:, None])
        return logits[:, -1, :], cache

    nll_sum, n, tops, gaps = 0.0, 0, [], []
    toks = jnp.asarray(X)
    for t in range(STEPS):
        logits, cache = step(jp, toks[:, t:t + 1], cache,
                             jnp.full((B,), t, jnp.int32))
        lg = np.asarray(logits, np.float32)
        lg = lg - lg.max(-1, keepdims=True)
        lse = np.log(np.exp(lg).sum(-1))
        nll_sum += float((lse - lg[np.arange(B), Y[:, t]]).sum())
        n += B
        tops.append(lg.argmax(-1))
        top2 = np.sort(lg, -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
    return float(np.exp(nll_sum / n)), np.stack(tops), np.stack(gaps)


@pytest.mark.parametrize("n_head", [4, 6], ids=["E_kv128", "E_kv192"])
def test_decode_scoring_matches_jax(n_head):
    jcfg = jllama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=32 * n_head,
                              n_head=n_head, n_head_kv=n_head, n_layer=2,
                              n_ff=256)
    cfg = llama.LlamaConfig(**{k: getattr(jcfg, k) for k in (
        "n_vocab", "n_ctx", "n_embd", "n_head", "n_head_kv", "n_layer",
        "n_ff")})
    jp = jllama.init_params(jax.random.PRNGKey(n_head), jcfg,
                            dtype=jnp.float32)
    # weights of N(0, 0.02) give a flat softmax; scale them up so that the
    # caches' rounding reaches the logits
    jp = jax.tree.map(lambda x: x * 8.0 if x.ndim == 2 else x, jp)
    params = params_from_jax(_wire(jp), device="cpu")
    rng = np.random.default_rng(n_head)
    stream = rng.integers(0, 256, B * T + 1).astype(np.int32)
    X, Y = kv_quality.chunks(stream, B, chunk=T)
    assert X.shape == (B, T) and np.array_equal(X[:, 1:], Y[:, :-1])
    rows = kv_quality.run(cfg, params, X, Y)
    assert [r[0] for r in rows] == [c[0] for c in kv_quality.CACHES]
    ref_top = None
    for (name, ppl, dppl, agree), (_, _, int8, flat), jdt in zip(
            rows, kv_quality.CACHES, JCACHES):
        want, top, gaps = _jax_run(jcfg, jp, X, Y, jdt, int8, flat)
        np.testing.assert_allclose(ppl, want, rtol=1e-4 if flat else 1e-5,
                                   err_msg=name)
        _, ptop, _ = kv_quality.decode_score(
            cfg, params, X, Y, torch.bfloat16 if flat else torch.float32,
            int8, flat)
        decided = gaps >= 1e-3
        assert np.array_equal(ptop[decided], top[decided]), name
        if ref_top is None:
            ref_top, ref_ppl = top, want
            assert dppl == 0.0 and agree == 1.0
        else:
            np.testing.assert_allclose(dppl, want - ref_ppl, atol=2e-4 * want)
            assert abs(agree - float((top == ref_top).mean())) <= 1 / 64


def test_captured_step_equals_eager_and_jax():
    """decode_score's step through its CapturedStep (on the CPU: eagerly
    through the static buffers, the cache written in place) gives the eager
    form's (captured.disabled()) ppl and argmax bit for bit for every
    cache, and the JAX script's ppl over the f32 cache within its bar."""
    from ggmlsharp_tpu_torch.models import captured

    jcfg = jllama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=128, n_head=4,
                              n_head_kv=4, n_layer=1, n_ff=256)
    cfg = llama.LlamaConfig(**{k: getattr(jcfg, k) for k in (
        "n_vocab", "n_ctx", "n_embd", "n_head", "n_head_kv", "n_layer",
        "n_ff")})
    jp = jax.tree.map(lambda x: x * 8.0 if x.ndim == 2 else x,
                      jllama.init_params(jax.random.PRNGKey(1), jcfg,
                                         dtype=jnp.float32))
    params = params_from_jax(_wire(jp), device="cpu")
    stream = np.random.default_rng(1).integers(0, 256, B * T + 1)
    X, Y = kv_quality.chunks(stream.astype(np.int32), B, chunk=T)
    for _, dtype, int8, flat in kv_quality.CACHES:
        ppl, top, n = kv_quality.decode_score(cfg, params, X, Y, dtype, int8,
                                              flat)
        with captured.disabled():
            eppl, etop, en = kv_quality.decode_score(cfg, params, X, Y,
                                                     dtype, int8, flat)
        assert (ppl, n) == (eppl, en) and np.array_equal(top, etop)
    want, _, _ = _jax_run(jcfg, jp, X, Y, jnp.float32, False, False)
    ppl, _, _ = kv_quality.decode_score(cfg, params, X, Y, torch.float32,
                                        False, False)
    np.testing.assert_allclose(ppl, want, rtol=1e-5)
