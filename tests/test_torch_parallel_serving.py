"""Tensor-parallel serving (``Engine(mesh=)``) against the JAX package's
unsharded engine on the same weights and requests, on the CPU.

The cases are JAX's own test_engine_tensor_parallel_* tests
(tests/test_parallel.py, slow-marked there: llama, GPT-2 with its
vocab-sharded embedding and gathered logits, speculative serving with the
draft sharded too, and prefix caching), on their configs, seeds, prompts
and spec_k. The JAX engine runs unsharded in the test process (GSPMD
computes the same function on a mesh); the trees cross to the port as
ggml wire bytes (test_torch_llama.to_port_tree), bit for bit. The port's
side runs in one spawned world of 2 gloo ranks
(tests/_torch_parallel_ranks.serving), every rank running the same
schedule over a sharded tree; each rank also runs the port's own
single-device engine. Greedy tokens must equal JAX's on every rank (f32
throughout: the routes differ in summation order only, and no top-2 gap
on these prompts is that small)."""
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_parallel_ranks as ranks
from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.serving import Engine as JEngine
from ggmlsharp_tpu.serving import Request as JRequest
from ggmlsharp_tpu_torch.parallel.distributed import spawn
from test_torch_llama import to_port_tree

GCFG = dict(n_vocab=128, n_ctx=64, n_embd=64, n_head=4, n_layer=2)
PREFIX = [3, 7, 11, 2]
CASES = {
    "llama": dict(model="llama", prompts=[[3, 7, 11], [5, 2],
                                          [9, 9, 9, 9, 1]],
                  n_new=6, spec_k=0, prefix=None),
    "gpt2": dict(model="gpt2", prompts=[[5, 17, 99], [7, 1]], n_new=5,
                 spec_k=0, prefix=None),
    "spec": dict(model="llama", prompts=[[3, 7, 11], [5, 2, 8, 1]],
                 n_new=5, spec_k=2, prefix=None),
    "prefix": dict(model="llama", prompts=[PREFIX + [5], PREFIX], n_new=4,
                   spec_k=0, prefix=PREFIX),
}


def _jax_tokens(trees, case):
    mod, cfg, params = trees[case["model"]]
    kw = {}
    if case["spec_k"]:
        kw = dict(draft_forward=jllama.forward, draft_cfg=cfg,
                  draft_params=trees["draft"], spec_k=case["spec_k"])
    eng = JEngine(mod.forward, cfg, params, batch_slots=2,
                  cache_dtype=jnp.float32, **kw)
    pid = eng.register_prefix(case["prefix"]) if case["prefix"] else None
    for i, p in enumerate(case["prompts"]):
        eng.submit(JRequest(id=i, prompt=list(p),
                            max_new_tokens=case["n_new"], prefix_id=pid))
    return {r.id: r.out_tokens for r in eng.run()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serving"))
    jcfg = jllama.TINY_LLAMA
    jl = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jd = jllama.init_params(jax.random.PRNGKey(9), jcfg, dtype=jnp.float32)
    gcfg = jgpt2.GPT2Config(**GCFG)
    jg = jgpt2.init_params(jax.random.PRNGKey(0), gcfg, dtype=jnp.float32)
    torch.save({"llama": to_port_tree(jl), "draft": to_port_tree(jd),
                "gpt2": to_port_tree(jg), "gpt2_cfg": GCFG, "cases": CASES},
               f"{out}/trees.pt")
    spawn(ranks.serving, 2, args=(out,), threads=1, init_file=f"{out}/store")
    trees = {"llama": (jllama, jcfg, jl), "gpt2": (jgpt2, gcfg, jg),
             "draft": jd}
    want = {name: _jax_tokens(trees, case) for name, case in CASES.items()}
    return want, [torch.load(f"{out}/serving_{r}.pt", weights_only=False)
                  for r in range(2)]


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_tokens_equal_jax(results, name):
    want, res = results
    assert all(len(t) == CASES[name]["n_new"] for t in want[name].values())
    for r in res:  # every rank emits JAX's unsharded engine's tokens
        assert r[name]["tp"] == want[name], (name, r[name]["tp"], want[name])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_tokens_equal_single_device(results, name):
    want, res = results
    for r in res:  # and the port's single-device engine's
        got = r[name]
        assert got["tp"] == got["single"] == want[name], (name, got)
        # the cache: head-major, the rank's half of the KV heads
        assert got["cache"] == ((2 if name == "gpt2" else 1), False)


def test_tp_engine_layout_follows_the_tree(results):
    """A sharded tree serves tensor-parallel without mesh= too: the same
    tokens over the same head-major cache of the local KV heads."""
    want, res = results
    for r in res:
        assert r["no_mesh"] == (want["llama"], (1, False))


def test_tp_engine_refuses_unsharded_params(results):
    """An unsharded tree, or one sharded on another mesh, is refused
    under mesh=."""
    for r in results[1]:
        unsharded, other = r["refused"]
        assert unsharded and "must be sharded" in unsharded
        assert other and "another mesh" in other
