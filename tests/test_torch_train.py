"""Training through the port's models against the JAX package on the CPU:
the JAX bench's training loss (bench.py ``BENCH_MODE=train``: a fresh
head-major cache of S rows, positions 0..S-1, ``prefix_bound=S``, mean
next-token NLL over f32 log-softmax) and its gradient for a tiny GPT-2 and
TINY_LLAMA (GQA n_rep 2), and one Adam step of ``optim.opt_fn``.

Parameters are drawn in numpy from a seed and handed to both packages. The
JAX loss runs flash_attention_cached (S 16 > 8: its Pallas kernel in
interpret mode, under the custom VJP) and is compiled with XLA's excess
precision off (test_torch_gpt2._jax_forward gives the reason); the port's
runs the kernel's Function, which on a CPU tensor runs _cached_ref forward
and recomputes it backward.

Tolerances, f32 parameters and cache: the packages differ in f32 summation
order and libm ulps (online vs dense softmax included): the loss to 1e-5,
each gradient leaf to 1e-5 of its largest entry plus 1e-7 (measured 8e-7
of it). One Adam step
moves a weight by alpha * m/(sqrt(v) + eps), about alpha * sign(g), so the
parameters agree to 1e-6 wherever the two gradients have one sign; a weight
whose gradient is below the gradients' noise (1e-4 of the leaf's largest)
may move either way: at most 2 * alpha. bf16 parameters (the card's
training dtype): the loss alone, to 1e-3 relative (bf16 rounds every op's
output, a half-ulp of 2e-3, at a few places in another order in each
package; measured 3.5e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import kv_cache as jkvc
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.optim import OptParams as JOptParams
from ggmlsharp_tpu.optim import opt_fn as jopt_fn
from ggmlsharp_tpu_torch.models import gpt2, llama
from ggmlsharp_tpu_torch.models.common import lm_loss, params_from_jax
from ggmlsharp_tpu_torch.optim import OptParams, opt_fn, value_and_grad
from ggmlsharp_tpu_torch.optim.tree import tree_leaves

B, S = 2, 16
GPT2_CFG = dict(n_vocab=64, n_ctx=32, n_embd=64, n_head=4, n_layer=2)
MODELS = {
    "gpt2": (jgpt2, gpt2, jgpt2.GPT2Config(**GPT2_CFG),
             gpt2.GPT2Config(**GPT2_CFG)),
    "tiny_llama": (jllama, llama, jllama.TINY_LLAMA, llama.TINY_LLAMA),
}


def _params(name, dtype=np.float32, seed=0):
    """A numpy tree of the JAX init_params structure: N(0, 0.02) weights,
    gains 1 + N(0, 0.1), biases N(0, 0.02)."""
    jmod, _, jcfg, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    tree = jmod.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)

    def draw(path, a):
        x = rng.standard_normal(a.shape).astype(np.float32) * 0.02
        if jax.tree_util.keystr(path).endswith(("['g']", "norm']")):
            x = 1.0 + x * 5
        return x.astype(dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.n_vocab, (B, S + 1)).astype(np.int32)


def _jax_loss_fn(jmod, jcfg, dtype):
    def loss_fn(p, toks):
        inp, tgt = toks[:, :-1], toks[:, 1:]
        cache = jkvc.init_cache(jcfg.n_layer, B,
                                getattr(jcfg, "n_head_kv", jcfg.n_head), S,
                                jcfg.head_dim, dtype=dtype)
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None],
                                     inp.shape)
        logits, _ = jmod.forward(p, jcfg, inp, cache, positions,
                                 prefix_bound=S)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    return loss_fn


def _jax_value_and_grad(jmod, jcfg, jp, toks, dtype=jnp.float32):
    fn = jax.value_and_grad(_jax_loss_fn(jmod, jcfg, dtype))
    return jax.jit(fn).lower(jp, toks).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp, toks)


def _port_tree(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_gradients_match_jax(name):
    jmod, tmod, jcfg, tcfg = MODELS[name]
    tree = _params(name)
    toks = _tokens(tcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jf, jg = _jax_value_and_grad(jmod, jcfg, jp, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    tp = _port_tree(tree)
    f, g = value_and_grad(lambda p: lm_loss(tmod.forward, tcfg, p, tt))(tp)
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-5, atol=1e-5)
    jl, tl = jax.tree.leaves(jg), tree_leaves(g)
    assert len(jl) == len(tl) == len(jax.tree.leaves(jp))
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max() + 1e-7)
    # every parameter receives a gradient, the K/V rows through the cache
    assert all(float(a.abs().max()) > 0 for a in tl)
    # the plain route (the reference a card run is held against) gives the
    # same loss and gradient on the CPU, bit for bit
    f2, g2 = value_and_grad(
        lambda p: lm_loss(tmod.forward, tcfg, p, tt, plain=True))(tp)
    assert float(f2) == float(f)
    assert all(torch.equal(a, b) for a, b in zip(tl, tree_leaves(g2)))


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_loss_matches_jax(name):
    jmod, tmod, jcfg, tcfg = MODELS[name]
    tree = _params(name)
    toks = _tokens(tcfg, seed=2)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    jf, _ = _jax_value_and_grad(jmod, jcfg, jp, jnp.asarray(toks),
                                jnp.bfloat16)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
    f = lm_loss(tmod.forward, tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-3)


@pytest.mark.parametrize("name", list(MODELS))
def test_one_adam_step_matches_jax(name):
    """opt_fn(loss, params, ADAM, n_iter 1): the parameters after the step
    and the loss it reports, against JAX opt_fn's."""
    jmod, tmod, jcfg, tcfg = MODELS[name]
    tree = _params(name, seed=3)
    toks = _tokens(tcfg, seed=4)
    jp = jax.tree.map(jnp.asarray, tree)
    jt = jnp.asarray(toks)
    jloss = _jax_loss_fn(jmod, jcfg, jnp.float32)
    jprm = JOptParams()
    jprm.adam.n_iter = 1
    jx, jfx, jres, jit_ = jopt_fn(lambda p: jloss(p, jt), jp, jprm)
    _, jg = _jax_value_and_grad(jmod, jcfg, jp, jt)
    prm = OptParams()
    prm.adam.n_iter = 1
    tt = torch.from_numpy(toks)
    tx, tfx, tres, tit = opt_fn(lambda p: lm_loss(tmod.forward, tcfg, p, tt),
                                _port_tree(tree), prm)
    assert (tres.name, tit) == (jres.name, jit_)
    np.testing.assert_allclose(tfx, float(jfx), rtol=1e-5)
    alpha = prm.adam.alpha
    for a, b, g in zip(tree_leaves(tx), jax.tree.leaves(jx),
                       jax.tree.leaves(jg)):
        b, g = np.asarray(b), np.abs(np.asarray(g))
        noisy = g <= 1e-4 * g.max()
        err = np.abs(a.numpy() - b)
        assert (err[~noisy] <= 1e-6).all(), float(err[~noisy].max())
        assert (err[noisy] <= 2 * alpha + 1e-6).all()
