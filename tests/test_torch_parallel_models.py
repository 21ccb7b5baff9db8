"""The port's tensor-parallel model forwards, pipeline-parallel scoring and
the GGML_TPU_ATTN=ring route against the JAX package's unsharded functions
(GSPMD computes the same function as the unsharded model), on the CPU.

The port's side runs in one spawned world of 2 gloo ranks
(tests/_torch_parallel_ranks.models): llama (separate and fused weights,
f32, and Q4_0) and GPT-2 sharded over model = 2 with a sharded head-major
cache, a prompt and one decode step; llama.forward_pp over 2 stages (the
whole tree, the fused tree, and each rank's own blocks only); the ring
route over a 2-rank sequence mesh (head-major and flat caches), against
JAX's legacy route (tests/test_parallel.py::
test_ring_attention_model_integration's setup). Tolerances: 2e-4 on f32
logits (tests/test_parallel.py's bars), 2e-2 with Q4_0 weights and the Q8_0
activation round trip (test_torch_llama.py's: a one-ulp difference in the
order of the sum over ranks can move one activation by a whole Q8 step).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu_torch.parallel.distributed import spawn
from test_torch_llama import to_port_tree

LCFG = dict(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_head_kv=2,
            n_layer=2, n_ff=512)
GCFG = dict(n_vocab=101, n_ctx=64, n_embd=64, n_head=4, n_layer=2)
PPCFG = dict(n_vocab=256, n_ctx=64, n_embd=128, n_head=4, n_head_kv=2,
             n_layer=4, n_ff=256)
B, S = 2, 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("models"))
    jl = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**LCFG),
                            dtype=jnp.float32)
    jq = jllama.quantize_params(
        jllama.init_params(jax.random.PRNGKey(3), jllama.LlamaConfig(**LCFG)),
        JGType.Q4_0, swar=False)
    jg = jgpt2.init_params(jax.random.PRNGKey(1), jgpt2.GPT2Config(**GCFG),
                           dtype=jnp.float32)
    jp = jllama.init_params(jax.random.PRNGKey(5),
                            jllama.LlamaConfig(**PPCFG), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    trees = {"llama_cfg": LCFG, "gpt2_cfg": GCFG, "pp_cfg": PPCFG,
             "llama": to_port_tree(jl), "llama_q4_0": to_port_tree(jq),
             "gpt2": to_port_tree(jg), "pp": to_port_tree(jp),
             "tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "pp_tokens": rng.integers(0, 256, (4, S)).astype(np.int32),
             "ring_tokens": rng.integers(0, 256, (2, 32)).astype(np.int32)}
    torch.save(trees, f"{out}/trees.pt")
    spawn(ranks.models, 2, args=(out,), threads=1, init_file=f"{out}/store")
    res = [torch.load(f"{out}/models_{r}.pt", weights_only=False)
           for r in range(2)]
    return trees, {"llama": jl, "llama_q4_0": jq, "gpt2": jg, "pp": jp}, res


def _jax_forward(mod, cfg, params, toks, nxt=None, attn=None):
    """JAX's unsharded prompt logits over a fresh f32 head-major cache (and
    one decode step of token ``nxt``)."""
    bb, ss = toks.shape
    old = os.environ.get("GGML_TPU_ATTN")
    if attn:
        os.environ["GGML_TPU_ATTN"] = attn
    try:
        cache = mod.new_cache(cfg, bb, dtype=jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(ss, dtype=jnp.int32)[None],
                               (bb, ss))
        lg, cache = mod.forward(params, cfg, jnp.asarray(toks), cache, pos)
        if nxt is None:
            return np.asarray(lg)
        lg2, _ = mod.forward(params, cfg, jnp.asarray(nxt), cache,
                             pos[:, -1:] + 1)
        return np.asarray(lg), np.asarray(lg2)
    finally:
        os.environ.pop("GGML_TPU_ATTN", None)
        if old is not None:
            os.environ["GGML_TPU_ATTN"] = old


@pytest.mark.parametrize("name,tol", [("llama", 2e-4), ("llama_fused", 2e-4),
                                      ("llama_q4_0", 2e-2)])
def test_tp_llama_matches_jax(world, name, tol):
    trees, jt, res = world
    lg, lg2, nxt = res[0][name]
    jparams = jt["llama_q4_0" if name == "llama_q4_0" else "llama"]
    want, want2 = _jax_forward(jllama, jllama.LlamaConfig(**LCFG), jparams,
                               trees["tokens"], nxt.numpy())
    assert lg.shape == (B, S, LCFG["n_vocab"])
    np.testing.assert_allclose(lg.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(lg2.numpy(), want2, rtol=tol, atol=tol)
    for i in range(3):  # both ranks hold the same logits
        assert torch.equal(res[0][name][i], res[1][name][i])


def test_tp_gpt2_matches_jax(world):
    trees, jt, res = world
    want = _jax_forward(jgpt2, jgpt2.GPT2Config(**GCFG), jt["gpt2"],
                        trees["tokens"] % GCFG["n_vocab"])
    got = res[0]["gpt2"]
    assert got.shape == (B, S, GCFG["n_vocab"])  # 101 rows padded to 102
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, res[1]["gpt2"])


@pytest.mark.parametrize("key", ["pp", "pp_fused", "pp_own"])
def test_forward_pp_matches_jax(world, key):
    trees, jt, res = world
    want = _jax_forward(jllama, jllama.LlamaConfig(**PPCFG), jt["pp"],
                        trees["pp_tokens"])
    np.testing.assert_allclose(res[0][key].numpy(), want, rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(res[0][key], res[1][key])


@pytest.mark.parametrize("key", ["ring_model", "ring_model_flat"])
def test_ring_route_matches_jax_legacy(world, key):
    trees, jt, res = world
    want = _jax_forward(jllama, jllama.LlamaConfig(**LCFG), jt["llama"],
                        trees["ring_tokens"], attn="legacy")
    np.testing.assert_allclose(res[0][key].numpy(), want, rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(res[0][key], res[1][key])
