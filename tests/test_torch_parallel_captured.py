"""The tensor-parallel engine and the distributed training example's step
through their captured route (``common.capturable``: a model axis over
NCCL captures, over gloo runs eagerly), on the CPU, in one spawned world of
2 gloo ranks (tests/_torch_parallel_ranks.captured_routes).

The route is chosen from the backend's name; the ranks stub the name to
"nccl" (the collectives still run on gloo: on the CPU nothing stages), so
the engine's decode step and admissions and the example's step are
CapturedSteps, which on the CPU run eagerly through their static buffers:

  * ``Engine(mesh=)`` on that route answers test_torch_parallel_serving's
    llama case token for token as JAX's engine (the same trees; the JAX
    engine runs unsharded, GSPMD's function), and says it captures; under
    the real gloo name it says it does not;
  * the example's ``sgd_step`` gives bit-equal losses in its captured and
    eager (``captured.disabled()``) forms from one state, updates the
    state's own tensors in place (their addresses kept) to bit-equal
    values, and under the gloo name is eager and gives the same losses;
  * that step against JAX's jitted ``sgd_step`` of
    examples/train_distributed.py (its ``loss_fn`` over the whole batch,
    the two ranks' shards, SGD at 0.1) from the JAX example's init over 3
    steps: the losses to 1e-5 relative and each leaf's update to 1e-5 of
    its largest entry (the gradient bar of test_torch_train.py: the
    packages differ in f32 summation order) plus one f32 ulp of the leaf's
    largest weight (the update is rounded into the weight, e.g. a gain
    near 1).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu_torch.parallel.distributed import spawn
from test_torch_llama import to_port_tree
from test_torch_parallel_serving import CASES, _jax_tokens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_init():
    """The JAX example's init: GPT-2 at its config, f32, PRNGKey(0)."""
    return jgpt2.init_params(jax.random.PRNGKey(0),
                             jgpt2.GPT2Config(**ranks.TRAIN_CFG),
                             dtype=jnp.float32)


def _jax_sgd(n=3):
    """JAX's sgd_step of examples/train_distributed.py over both ranks'
    shards, n steps from the init: (losses, the parameters after)."""
    cfg = jgpt2.GPT2Config(**ranks.TRAIN_CFG)
    toks = jnp.asarray(np.concatenate(
        [ranks.train_tokens(r) for r in range(2)]).astype(np.int32))
    B, S = toks.shape[0], toks.shape[1] - 1

    def loss_fn(p, toks):
        inp, tgt = toks[:, :-1], toks[:, 1:]
        cache = jgpt2.new_cache(cfg, B, dtype=jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None],
                               inp.shape)
        logits, _ = jgpt2.forward(p, cfg, inp, cache, pos)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], axis=-1))

    def sgd_step(p, toks):
        loss, g = jax.value_and_grad(loss_fn)(p, toks)
        return jax.tree.map(lambda w, gw: w - 0.1 * gw, p, g), loss

    p = _jax_init()
    step = jax.jit(sgd_step).lower(p, toks).compile(
        compiler_options={"xla_allow_excess_precision": False})
    losses = []
    for _ in range(n):
        p, loss = step(p, toks)
        losses.append(float(loss))
    return losses, p


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("captured_routes"))
    jcfg = jllama.TINY_LLAMA
    jl = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    torch.save({"llama": to_port_tree(jl), "cases": CASES,
                "gpt2_train": jax.tree.map(np.asarray, _jax_init())},
               f"{out}/trees.pt")
    spawn(ranks.captured_routes, 2, args=(out, ROOT), threads=1,
          init_file=f"{out}/store")
    want = _jax_tokens({"llama": (jllama, jcfg, jl)}, CASES["llama"])
    return want, [torch.load(f"{out}/captured_routes_{r}.pt",
                             weights_only=False) for r in range(2)]


def test_nccl_tp_engine_captures_and_gives_jax_tokens(results):
    want, res = results
    assert all(len(t) == CASES["llama"]["n_new"] for t in want.values())
    for r in res:
        assert r["nccl_engine"] == (True, True)
        assert r["tokens"] == want, (r["tokens"], want)


def test_gloo_tp_engine_stays_eager(results):
    for r in results[1]:
        assert r["gloo_engine"] == (False, False)


def test_train_step_captured_equals_eager_in_place(results):
    for r in results[1]:
        tr = r["train"]
        assert (tr["captured"]["captured"], tr["eager"]["captured"],
                tr["gloo"]["captured"]) == (True, True, False)
        assert tr["captured"]["losses"] == tr["eager"]["losses"] \
            == tr["gloo"]["losses"]
        assert tr["captured"]["losses"][-1] < tr["captured"]["losses"][0]
        for form in ("captured", "eager", "gloo"):
            assert tr[form]["in_place"]
        for a, b in zip(tr["captured"]["state"], tr["eager"]["state"]):
            assert torch.equal(a, b)
    # every rank sees the loss averaged over data, the same on both ranks
    a, b = (r["train"]["captured"]["losses"] for r in results[1])
    assert a == b


def test_train_step_matches_jax_sgd_step(results):
    losses, p = _jax_sgd()
    init = [np.asarray(w) for w in jax.tree.leaves(_jax_init())]
    want = [np.asarray(w) - w0 for w, w0 in zip(jax.tree.leaves(p), init)]
    for r in results[1]:
        tr = r["train"]["captured"]
        np.testing.assert_allclose(tr["losses"], losses, rtol=1e-5)
        assert len(tr["state"]) == len(want)
        for w, w0, d in zip(tr["state"], init, want):
            assert w.shape == d.shape
            ulp = np.finfo(np.float32).eps * np.abs(w0).max()
            np.testing.assert_allclose(w.numpy() - w0, d, rtol=0,
                                       atol=1e-5 * np.abs(d).max() + ulp)
