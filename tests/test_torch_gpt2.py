"""The port's GPT-2 slice against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
cross as ggml wire bytes (io.gguf.qtensor_to_wire -> gpt2.params_from_jax), so
both hold bit-identical parameters. Where the JAX function reaches a Pallas
kernel (the Q8_0 SWAR matmul, the fused MLP, the whole-block layer kernel) it
runs in interpret mode, as the JAX package's own tests run it; the port's
wrappers run their plain versions (CPU tensors).

The config quantizes every matmul weight (n_embd 256; GPT2_TINY's 128 would
leave them dense) and has a vocabulary that is no multiple of the JAX
package's row padding, so the port's unpadded LM head is exercised.

Tolerances:
  * single ops and kernels (norm, gelu, matmul, MLP, layer): the packages
    differ in f32 summation order and libm ulps only. 1e-5 on values of
    magnitude ~1 for one product; 5e-5 for the MLP's two chained products;
    2e-4 for the layer's five chained products and softmax (the JAX
    package's own bar for its kernel's k_new / v_new);
  * whole model, weight-only (GGML_TPU_QUANT_ACTS=0): bf16 cache rows can
    round a one-ulp f32 difference to a whole bf16 step; measured 2e-5 on
    the flat and head-major routes and 5e-5 over the read-back prefix, on
    logits of magnitude ~1: 2e-4. The JAX reference is compiled with XLA's
    excess precision off (see _jax_forward);
  * whole model with the Q8_0 activation round trip (the default): an f32
    input one ulp apart can move an activation by a whole Q8 step
    (amax/127): 2e-2, the llama slice's bar.
Greedy tokens must agree wherever the JAX top-2 logit gap exceeds the
tolerance (a smaller gap may fairly flip, and the runs part from there).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import ops as jops
from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.kernels.gpt2_layer import fuse_gpt2_layer
from ggmlsharp_tpu.kernels.gpt2_layer import gpt2_layer_step as jlayer_step
from ggmlsharp_tpu.kernels.matmul_q import mul_mat_q_fused as jmul_mat_q_fused
from ggmlsharp_tpu.kernels.mlp_fused import flash_ff_q8 as jflash_ff_q8
from ggmlsharp_tpu.kernels.mlp_fused import fuse_mlp_q8, q8_korder_perm
from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.ops.matmul import mul_mat_q as jmul_mat_q
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu.quant.formats import swar_unpack_values_q8, to_swar
from ggmlsharp_tpu.quant.quantize import dequantize as jdequantize
from ggmlsharp_tpu.quant.quantize import quantize as jquantize
from ggmlsharp_tpu_torch import GType, ops
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.kernels.gpt2_layer import (
    gpt2_layer_fuse_supported, gpt2_layer_step,
)
from ggmlsharp_tpu_torch.kernels.mlp_fused import (
    _MAX_FUSED_B, flash_ff_q8, mlp_fuse_supported,
)
from ggmlsharp_tpu_torch.models import gpt2, sampling
from ggmlsharp_tpu_torch.ops.basic import gelu, norm
from ggmlsharp_tpu_torch.quant.formats import QTensor, from_wire, to_wire
from ggmlsharp_tpu_torch.quant.quantize import dequantize


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package: its matmuls multiply f32 operands exactly on the CPU in
    either of its modes (DEFAULT precision is f32 there). The port's "bf16"
    function is held against JAX in test_torch_mm_dot.py."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


CFG = dict(n_vocab=500, n_ctx=128, n_embd=256, n_head=4, n_layer=2)
E, H, F, T = 256, 4, 1024, 64
EPS = 1e-5
PROMPT_LEN, N_NEW = 16, 6


def _f32(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


def _to_port(jq):
    """A JAX QTensor as a port QTensor on the CPU, through wire bytes."""
    g, wire = qtensor_to_wire(jq)
    return from_wire(GType(int(g)), wire, jq.shape, device="cpu")


def to_port_tree(x):
    """JAX parameter tree -> numpy / (gtype, wire bytes, shape) leaves."""
    if isinstance(x, JQTensor):
        g, wire = qtensor_to_wire(x)
        return (int(g), wire, x.shape)
    if isinstance(x, dict):
        return {k: to_port_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port_tree(v) for v in x]
    return np.asarray(x)


# --- (a) ops ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["norm", "gelu"])
def test_op_matches_jax(name):
    x = _f32(np.random.default_rng(1), 5, 256, scale=2.0)
    want = np.asarray(getattr(jops, name)(jnp.asarray(x)))
    got = getattr(ops, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- (b) Q8_0 matmul ---------------------------------------------------------

def _q8_pair(n, k, seed):
    jw = jquantize(jnp.asarray(_f32(np.random.default_rng(seed), n, k,
                                    scale=0.05)), JGType.Q8_0)
    return jw, _to_port(jw)


@pytest.mark.parametrize("quantize_acts", [True, False])
@pytest.mark.parametrize("rows", [1, 2, 5, 16, 64])
@pytest.mark.parametrize("n,k", [(768, 256), (500, 1024)])
def test_q8_0_mul_mat_matches_jax(rows, n, k, quantize_acts):
    jw, tw = _q8_pair(n, k, seed=rows + n + k)
    x = _f32(np.random.default_rng(rows), rows, k)
    want = np.asarray(jmul_mat_q(jw, jnp.asarray(x),
                                 quantize_acts=quantize_acts))
    got = ops.mul_mat(tw, torch.from_numpy(x), quantize_acts=quantize_acts)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_q8_0_mul_mat_matches_swar_kernel():
    """Against the TPU kernel itself (to_swar + the SWAR Q8_0 kernel in
    interpret mode); 2e-5 is that kernel's own parity bar."""
    jw, tw = _q8_pair(512, 256, seed=2)
    x = _f32(np.random.default_rng(3), 3, 256)
    want = np.asarray(jmul_mat_q_fused(to_swar(jw), jnp.asarray(x),
                                       quantize_acts=False))
    got = ops.mul_mat(tw, torch.from_numpy(x), quantize_acts=False).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_linear_adds_the_bias():
    from ggmlsharp_tpu_torch.models.common import linear

    _, tw = _q8_pair(256, 256, seed=4)
    rng = np.random.default_rng(5)
    x, b = torch.from_numpy(_f32(rng, 2, 256)), torch.from_numpy(_f32(rng, 256))
    assert torch.equal(linear(tw, x, b), linear(tw, x) + b)
    assert torch.equal(linear(tw.planes["d"].float(), x[:, :8], b),
                       ops.mul_mat_f(tw.planes["d"].float(), x[:, :8]) + b)


# --- (c) fused MLP -----------------------------------------------------------

def _mlp_pair(seed):
    rng = np.random.default_rng(seed)
    q1 = jquantize(jnp.asarray(_f32(rng, F, E, scale=0.1)), JGType.Q8_0)
    q2 = jquantize(jnp.asarray(_f32(rng, E, F, scale=0.1)), JGType.Q8_0)
    return q1, _f32(rng, F, scale=0.05), q2, _f32(rng, E, scale=0.05)


@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("rows", [1, 16, 64])
def test_flash_ff_q8_matches_jax(rows, quantize_acts):
    q1, b1, q2, b2 = _mlp_pair(11)
    x = _f32(np.random.default_rng(rows), rows, E)
    fused = fuse_mlp_q8(q1, jnp.asarray(b1), q2, jnp.asarray(b2))
    want = np.asarray(jflash_ff_q8(fused, jnp.asarray(x),
                                   quantize_acts=quantize_acts))
    got = flash_ff_q8(_to_port(q1), torch.from_numpy(b1), _to_port(q2),
                      torch.from_numpy(b2), torch.from_numpy(x),
                      quantize_acts=quantize_acts)
    assert tuple(got.shape) == (rows, E)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)


def test_flash_ff_q8_keeps_leading_dims():
    q1, b1, q2, b2 = _mlp_pair(12)
    args = (_to_port(q1), torch.from_numpy(b1), _to_port(q2),
            torch.from_numpy(b2))
    x = torch.from_numpy(_f32(np.random.default_rng(0), 2, 3, E))
    out = flash_ff_q8(*args, x)
    assert tuple(out.shape) == (2, 3, E)
    assert torch.equal(out.reshape(6, E), flash_ff_q8(*args, x.reshape(6, E)))


def test_fuse_gates_match_jax():
    from ggmlsharp_tpu.kernels.gpt2_layer import (
        gpt2_layer_fuse_supported as jsupported,
    )
    from ggmlsharp_tpu.kernels.mlp_fused import (
        _MAX_FUSED_B as jmax, mlp_fuse_supported as jmlp_supported,
    )

    q1, _, q2, _ = _mlp_pair(13)
    t1, t2 = _to_port(q1), _to_port(q2)
    assert _MAX_FUSED_B == jmax
    for b in (None, 1, 64, 65):
        assert mlp_fuse_supported(t1, t2, b) == jmlp_supported(q1, q2, b)
    assert not mlp_fuse_supported(t1, t1)  # k2 != n1
    assert not mlp_fuse_supported(t1, dequantize(t2))  # a dense weight
    for cfg in (gpt2.GPT2_124M, gpt2.GPT2_355M, gpt2.GPT2_774M,
                gpt2.GPT2_1558M, gpt2.GPT2Config(**CFG)):
        e = cfg.n_embd
        assert gpt2_layer_fuse_supported(e, 4 * e) == jsupported(e, 4 * e)
    assert not gpt2_layer_fuse_supported(1600, 6400)  # GPT-2 1558M


# --- (d) whole-block layer ---------------------------------------------------

def _rand_block(rng):
    def r(*s):
        return _f32(rng, *s, scale=0.1)

    return {
        "ln_1": {"g": 1.0 + 0.1 * r(E), "b": 0.05 * r(E)},
        "attn": {"c_attn_w": r(3 * E, E), "c_attn_b": 0.1 * r(3 * E),
                 "c_proj_w": r(E, E), "c_proj_b": 0.1 * r(E)},
        "ln_2": {"g": 1.0 + 0.1 * r(E), "b": 0.05 * r(E)},
        "mlp": {"c_fc_w": r(F, E), "c_fc_b": 0.1 * r(F),
                "c_proj_w": r(E, F), "c_proj_b": 0.1 * r(E)},
    }


def _port_block(blk):
    """The numpy block with its weights quantized by the JAX package and
    carried over as wire bytes; vectors as f32 tensors."""
    out = {}
    for name, sub in blk.items():
        out[name] = {}
        for k, v in sub.items():
            if v.ndim == 2:
                out[name][k] = _to_port(jquantize(jnp.asarray(v),
                                                  JGType.Q8_0))
            else:
                out[name][k] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("npast", [0, 5, T // 2, T - 1])
def test_gpt2_layer_step_matches_jax(npast):
    """The JAX kernel takes and returns wire-order vectors; the permutation
    sigma is applied here, on the test's side only."""
    rng = np.random.default_rng(npast)
    blk = _rand_block(rng)
    fused = fuse_gpt2_layer({n: {k: jnp.asarray(v) for k, v in s.items()}
                             for n, s in blk.items()})
    sig = q8_korder_perm(E)
    inv = np.argsort(sig)
    x = _f32(rng, 1, E, scale=0.5)
    # npast = 0 must ignore every cache row: fill them with large garbage
    kc = _f32(rng, T, E, scale=9.0 if npast == 0 else 0.3)
    vc = _f32(rng, T, E, scale=9.0 if npast == 0 else 0.3)
    want = jlayer_step(fused, jnp.asarray(x[:, sig]), jnp.asarray(kc[:, sig]),
                       jnp.asarray(vc[:, sig]), jnp.int32(npast), H, EPS)
    got = gpt2_layer_step(_port_block(blk), torch.from_numpy(x),
                          torch.from_numpy(kc), torch.from_numpy(vc),
                          torch.tensor(npast, dtype=torch.int32), H, EPS)
    for g, w, name in zip(got, want, ("y", "k_new", "v_new")):
        assert tuple(g.shape) == (1, E), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, inv],
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def _y_term_sums(blk, x, kc, vc):
    """S_i = |x2_i| + sum_f |W2_if h_f| + |b2_i|: the magnitude of the
    terms summed into output i of a layer step that attends every row of
    kc/vc, from the dequantized weights in f32."""
    D = E // H
    attn, mlp = blk["attn"], blk["mlp"]

    def ln(v, p):
        return norm(v, EPS) * p["g"] + p["b"]

    def mm(w, v):
        return v @ dequantize(w).to(torch.float32).T

    q, k, v = (mm(attn["c_attn_w"], ln(x, blk["ln_1"]))
               + attn["c_attn_b"]).split(E, -1)
    kh = torch.cat([kc, k]).reshape(-1, H, D)
    vh = torch.cat([vc, v]).reshape(-1, H, D)
    p = torch.softmax(torch.einsum("hd,thd->ht", q.reshape(H, D) / D ** 0.5,
                                   kh), -1)
    a = torch.einsum("ht,thd->hd", p, vh).reshape(1, E)
    x2 = x + mm(attn["c_proj_w"], a) + attn["c_proj_b"]
    h = gelu(mm(mlp["c_fc_w"], ln(x2, blk["ln_2"])) + mlp["c_fc_b"])
    w2 = dequantize(mlp["c_proj_w"]).to(torch.float32)
    return x2.abs() + h.abs() @ w2.abs().T + mlp["c_proj_b"].abs()


def test_gpt2_layer_step_beyond_the_bucket():
    """npast >= T: all T rows and the fresh one are attended (the same
    answer as a cache of T + 1 rows whose last row is stale).

    k_new and v_new do not read the cache: bit-equal. y: the two calls
    take the softmax and P.V over T + 1 and T + 2 keys, so their f32 sums
    round in another order; x2 = x + attn.Wp moves by a few ulps, and the
    MLP carries that into y. y is held to 4 ulps (4 * 2^-24) of S_i, the
    magnitude of the terms summed into y_i (_y_term_sums): the f32
    rounding noise of the output's own sum. (On this input the calls
    differ by up to 1.2 such ulps; 1e-6 of |y_i| is below one ulp of S_i
    where y_i is small.)"""
    rng = np.random.default_rng(7)
    blk = _port_block(_rand_block(rng))
    x = torch.from_numpy(_f32(rng, 1, E, scale=0.5))
    kc = torch.from_numpy(_f32(rng, T + 1, E, scale=0.3))
    vc = torch.from_numpy(_f32(rng, T + 1, E, scale=0.3))
    n = torch.tensor(T, dtype=torch.int32)
    a = gpt2_layer_step(blk, x, kc[:T], vc[:T], n + 3, H, EPS)
    b = gpt2_layer_step(blk, x, kc, vc, n, H, EPS)
    for u, v in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    bar = 4 * 2.0 ** -24 * _y_term_sums(blk, x, kc[:T], vc[:T])
    assert bool(((a[0] - b[0]).abs() <= bar).all()), \
        float(((a[0] - b[0]).abs() / bar).max())


# --- (e)-(g) the model -------------------------------------------------------

def _set_env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    return old


def _restore_env(old):
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def models():
    """One random model in three forms: the JAX tree with its TPU planes
    (SWAR weights, fused MLP, fused layer: the routes JAX really takes),
    the JAX tree in plain Q8_0 planes, and the port's tree carried over from
    the latter as wire bytes. Biases and layer norms are random, not the
    zeros and ones of init_params."""
    jcfg = jgpt2.GPT2Config(**CFG)
    raw = jgpt2.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)

    def vec(n, std, mean=0.0):
        return jnp.asarray(rng.standard_normal(n) * std + mean, jnp.bfloat16)

    def ln():
        return {"g": vec(E, 0.1, 1.0), "b": vec(E, 0.05)}

    raw["ln_f"] = ln()
    for b in raw["blocks"]:
        b["ln_1"], b["ln_2"] = ln(), ln()
        b["attn"]["c_attn_b"] = vec(3 * E, 0.05)
        b["attn"]["c_proj_b"] = vec(E, 0.05)
        b["mlp"]["c_fc_b"] = vec(F, 0.05)
        b["mlp"]["c_proj_b"] = vec(E, 0.05)
    old = _set_env(GGML_TPU_SWAR="1", GGML_TPU_MLP_FUSED="1",
                   GGML_TPU_LAYER_FUSED="1")
    try:
        jq = jgpt2.quantize_params(raw, JGType.Q8_0)
        os.environ["GGML_TPU_LAYER_FUSED"] = "0"
        jq_plain = jgpt2.quantize_params(raw, JGType.Q8_0, swar=False)
    finally:
        _restore_env(old)
    assert all("layer_fused" in b and "fused" in b["mlp"]
               for b in jq["blocks"])
    tq = gpt2.params_from_jax(to_port_tree(jq_plain), device="cpu")
    return jcfg, raw, jq, jq_plain, gpt2.GPT2Config(**CFG), tq


def _prompt(batch=1, n=PROMPT_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["n_vocab"], (batch, n)).astype(np.int32)


@pytest.fixture
def quant_acts(request, monkeypatch):
    """Both packages under one activation-quantization setting."""
    on = request.param
    monkeypatch.setattr(get_config(), "quantize_activations", on)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if on else "0")
    monkeypatch.setenv("GGML_TPU_LAYER_FUSED", "1")
    return on


ACTS = pytest.mark.parametrize("quant_acts,tol", [(False, 2e-4), (True, 2e-2)],
                               indirect=["quant_acts"])


_EXACT = {}


def _jax_forward(jcfg, jq, tokens, cache, positions, t_eff):
    """jgpt2.forward under jit, compiled with XLA's excess precision off.

    By default XLA drops the f32 -> bf16 -> f32 round trips between the
    model's bf16 ops (the embedding sum, the first block's layer norm), so
    the jitted function moves by 2.5e-3 on these logits from its own eager
    run; PyTorch rounds after every op, as the JAX function is written and as
    it runs eagerly (the port agrees with the eager run to 6e-7). With the
    option off the compiled reference rounds where the source says so."""
    key = (id(jq), tokens.shape, t_eff, get_config().quantize_activations,
           str(cache.k[0].dtype), cache.k[0].shape)
    if key not in _EXACT:
        def fn(p, t, c, pos):
            return jgpt2.forward(p, jcfg, t, c, pos, prefix_bound=t_eff)

        _EXACT[key] = jax.jit(fn).lower(jq, tokens, cache, positions).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return _EXACT[key](jq, tokens, cache, positions)


def _jax_steps(jcfg, jq, prompt, toks, batch=1, **cache_kw):
    """JAX logits of the prefill and of each decode step fed ``toks``."""
    cache = jgpt2.new_cache(jcfg, batch, **cache_kw)
    S = prompt.shape[1]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (batch, S))
    lg, cache = _jax_forward(jcfg, jq, jnp.asarray(prompt), cache, pos,
                             jsampling.length_bucket(S, jcfg.n_ctx))
    rows = [np.asarray(lg[:, -1])]
    for i in range(toks.shape[1]):
        pos = jnp.full((batch, 1), S + i, jnp.int32)
        lg, cache = _jax_forward(
            jcfg, jq, jnp.asarray(toks[:, i:i + 1]), cache, pos,
            jsampling.length_bucket(S + i + 1, jcfg.n_ctx))
        rows.append(np.asarray(lg[:, -1]))
    return np.stack(rows), cache


def _port_steps(tcfg, tq, prompt, toks, batch=1, **cache_kw):
    prefill, step = sampling.make_decode_fns(gpt2.forward, tcfg)
    cache = gpt2.new_cache(tcfg, batch, device="cpu", **cache_kw)
    cur = prompt.shape[1]
    with torch.inference_mode():
        lg, cache = prefill(tq, torch.from_numpy(prompt), cache,
                            t_eff=sampling.length_bucket(cur, tcfg.n_ctx))
        rows = [lg.numpy()]
        for i in range(toks.shape[1]):
            cur += 1
            lg, cache = step(tq, torch.from_numpy(toks[:, i:i + 1].copy()), cache,
                             t_eff=sampling.length_bucket(cur, tcfg.n_ctx))
            rows.append(lg.numpy())
    return np.stack(rows), cache


@ACTS
def test_flat_prefill_decode_and_generate_match_jax(models, quant_acts, tol):
    """Routes 2 (16-token prefill: flash, fused MLP) and 1 (6 decode steps:
    the whole-block kernel) on the flat cache, step for step; then
    sampling.generate end to end."""
    jcfg, _, jq, _, tcfg, tq = models
    prompt = _prompt()
    jcache = jgpt2.new_cache(jcfg, 1)
    assert jcache.k[0].ndim == 3  # JAX picks the flat cache too
    jtoks, _ = jsampling.generate(jgpt2.forward, jcfg, jq, jnp.asarray(prompt),
                                  jcache, N_NEW)
    jtoks = np.asarray(jtoks)
    jlog, jc = _jax_steps(jcfg, jq, prompt, jtoks[:, :-1])
    plog, pc = _port_steps(tcfg, tq, prompt, jtoks[:, :-1])
    assert pc.is_flat and plog.shape == (N_NEW, 1, CFG["n_vocab"])
    np.testing.assert_allclose(plog, jlog, rtol=0, atol=tol)
    # the cache rows: element order here, wire order there (bf16 storage)
    sig = q8_korder_perm(E)
    n = PROMPT_LEN + N_NEW - 1
    np.testing.assert_allclose(
        pc.k[1][0, :n].float().numpy()[:, sig],
        np.asarray(jc.k[1][0, :n], np.float32), rtol=2e-2, atol=tol)
    ptoks, cache = sampling.generate(gpt2.forward, tcfg, tq,
                                     torch.from_numpy(prompt),
                                     gpt2.new_cache(tcfg, 1, device="cpu"),
                                     N_NEW)
    assert int(cache.length[0]) == PROMPT_LEN + N_NEW
    ptoks = ptoks.numpy()
    for i in range(N_NEW):
        row = jlog[i, 0]
        assert row[ptoks[0, i]] >= row.max() - tol, f"token {i}"
        if ptoks[0, i] != jtoks[0, i]:
            break


def bf16_noise_bar(jlog, tol, n_layer):
    """The bar of mm_dot "bf16" (the port's default) on logits ``jlog``
    [..., V]: the f32 bar ``tol`` plus the bf16 noise bar carried through
    the layers. Rounding a product's f32 operand to bf16 moves its output by
    at most 2^-8·|x·w|·sqrt(K) (test_torch_mm_dot.py), about 2^-8 of the
    output's RMS; norms and residuals pass a relative error on with gain
    ~1, so the stages' shares add: five a layer (its four products and its
    attention) and the LM head, each 2^-8 of a logit row's RMS. The JAX
    package multiplies f32 operands exactly on the CPU in either mode."""
    rms = np.sqrt(np.mean(np.square(jlog, dtype=np.float64), -1,
                          keepdims=True))
    return tol + (5 * n_layer + 1) * 2.0 ** -8 * rms


@ACTS
def test_default_mm_dot_bf16_matches_jax(models, monkeypatch, quant_acts,
                                         tol):
    """The port in its default mm_dot ("bf16": f32 activations rounded to
    bf16 in the products and decode attention) over route 2's prefill and
    route 1's decode steps, against JAX at bf16_noise_bar. The mode must
    reach the model: weight-only, the logits move from the "f32" run's by
    more than the f32 bar; with the Q8_0 round trip only the products of
    f32 x (the LM head) and attention round, and the logits still move."""
    jcfg, _, jq, _, tcfg, tq = models
    prompt = _prompt()
    jtoks, _ = jsampling.generate(jgpt2.forward, jcfg, jq,
                                  jnp.asarray(prompt),
                                  jgpt2.new_cache(jcfg, 1), N_NEW)
    jtoks = np.asarray(jtoks)
    jlog, _ = _jax_steps(jcfg, jq, prompt, jtoks[:, :-1])
    f32_log, _ = _port_steps(tcfg, tq, prompt, jtoks[:, :-1])
    monkeypatch.setattr(kcfg, "_mm_dot", None)
    assert kcfg.mm_dot_mode() == "bf16"
    plog, _ = _port_steps(tcfg, tq, prompt, jtoks[:, :-1])
    bar = bf16_noise_bar(jlog, tol, CFG["n_layer"])
    assert bool((np.abs(plog - jlog) <= bar).all()), \
        float((np.abs(plog - jlog) / bar).max())
    assert np.abs(plog - f32_log).max() > (0.0 if quant_acts else tol)
    ptoks, _ = sampling.generate(gpt2.forward, tcfg, tq,
                                 torch.from_numpy(prompt),
                                 gpt2.new_cache(tcfg, 1, device="cpu"), N_NEW)
    ptoks = ptoks.numpy()
    for i in range(N_NEW):
        row = jlog[i, 0]
        assert row[ptoks[0, i]] >= row.max() - bar[i, 0, 0], f"token {i}"
        if ptoks[0, i] != jtoks[0, i]:
            break


@ACTS
def test_short_prefill_over_live_prefix_matches_jax(models, quant_acts, tol):
    """Route 2 with S <= 8: five tokens at positions 16..20 attend the rows
    read back from the flat cache (bf16-rounded), not their fresh K/V."""
    jcfg, _, jq, _, tcfg, tq = models
    prompt, more = _prompt(), _prompt(n=5, seed=1)
    none = np.zeros((1, 0), np.int32)
    _, jc = _jax_steps(jcfg, jq, prompt, none)
    _, pc = _port_steps(tcfg, tq, prompt, none)
    pos = np.arange(PROMPT_LEN, PROMPT_LEN + 5, dtype=np.int32)[None]
    want = np.asarray(_jax_forward(jcfg, jq, jnp.asarray(more), jc,
                                   jnp.asarray(pos), jcfg.n_ctx)[0])
    with torch.inference_mode():
        got, pc = gpt2.forward(tq, tcfg, torch.from_numpy(more), pc,
                               torch.from_numpy(pos),
                               prefix_bound=tcfg.n_ctx)
    assert int(pc.length[0]) == PROMPT_LEN + 5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@ACTS
def test_head_major_batch_decode_matches_jax(models, quant_acts, tol):
    """Route 3: batch 3 takes the head-major cache in both packages; a
    10-token prefill (flash over the cache prefix) and 3 decode steps."""
    jcfg, _, jq, _, tcfg, tq = models
    prompt = _prompt(batch=3, n=10, seed=2)
    toks = _prompt(batch=3, n=3, seed=3)
    jlog, jc = _jax_steps(jcfg, jq, prompt, toks, batch=3)
    plog, pc = _port_steps(tcfg, tq, prompt, toks, batch=3)
    assert jc.k[0].ndim == 4 and not pc.is_flat
    np.testing.assert_allclose(plog, jlog, rtol=0, atol=tol)


def _scale_bits(plane):
    """A packed f16-pair scale plane (C/2, N) uint32 -> f16 bits (N, C)."""
    w = np.asarray(plane).T
    return np.concatenate([w & 0xFFFF, w >> 16], axis=1).astype(np.uint16)


def test_params_from_jax_is_bit_exact(models):
    """Every leaf crosses bit for bit, and the planes the JAX kernels read
    (permuted, packed for the TPU) hold the payload bits of the port's one
    copy of each weight."""
    _, raw, jq, jq_plain, tcfg, tq = models
    assert to_wire(tq["wte"]) == qtensor_to_wire(jq_plain["wte"])[1]
    assert tq["wpe"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tq["wpe"].float().numpy(),
                                  np.asarray(raw["wpe"], np.float32))
    sE, sF = q8_korder_perm(E), q8_korder_perm(F)
    perm3 = np.concatenate([sE, E + sE, 2 * E + sE])
    for jb, jf, tb in zip(jq_plain["blocks"], jq["blocks"], tq["blocks"]):
        for grp in ("attn", "mlp"):
            for key, leaf in tb[grp].items():
                if isinstance(leaf, QTensor):
                    assert to_wire(leaf) == qtensor_to_wire(jb[grp][key])[1]
                else:
                    np.testing.assert_array_equal(
                        leaf.float().numpy(),
                        np.asarray(jb[grp][key], np.float32))
        lf, mf = jf["layer_fused"], jf["mlp"]["fused"]
        for qs, d, bias, rows, w, b in (
                ("qs_a", "d_a", "b_a", perm3, tb["attn"]["c_attn_w"],
                 tb["attn"]["c_attn_b"]),
                ("qs_p", "d_p", "b_p", sE, tb["attn"]["c_proj_w"],
                 tb["attn"]["c_proj_b"]),
                ("qs_f", "d_f", "b_f", sF, tb["mlp"]["c_fc_w"],
                 tb["mlp"]["c_fc_b"]),
                ("qs_c", "d_c", "b_c", sE, tb["mlp"]["c_proj_w"],
                 tb["mlp"]["c_proj_b"])):
            n, k = w.shape
            np.testing.assert_array_equal(
                np.asarray(swar_unpack_values_q8(lf[qs], n, k)),
                w["qs"].numpy()[rows].astype(np.int32))
            np.testing.assert_array_equal(
                _scale_bits(lf[d]), w["d"].numpy()[rows].view(np.uint16))
            np.testing.assert_array_equal(np.asarray(lf[bias])[0],
                                          b.float().numpy()[rows])
        fc = tb["mlp"]["c_fc_w"]
        np.testing.assert_array_equal(
            np.asarray(swar_unpack_values_q8(mf["qs1"], F, E)),
            fc["qs"].numpy()[sF].astype(np.int32))
    # the SWAR LM-head copy dequantizes to the rows of the port's wte
    np.testing.assert_array_equal(
        np.asarray(jdequantize(jq["lm_head"]))[:CFG["n_vocab"]],
        dequantize(tq["wte"]).numpy()[:CFG["n_vocab"]])


def test_quantize_params_matches_jax(models):
    """The port's own quantize_params gives the JAX package's wire bytes; its
    wte keeps n_vocab rows (the JAX tree pads them for its kernel's tile)."""
    _, raw, _, jq_plain, tcfg, _ = models
    raw_t = gpt2.params_from_jax(to_port_tree(raw), device="cpu")
    tq = gpt2.quantize_params(raw_t, GType.Q8_0)
    V = CFG["n_vocab"]
    assert tq["wte"].shape == (V, E) and jq_plain["wte"].shape[0] > V
    wire = qtensor_to_wire(jq_plain["wte"])[1]
    assert to_wire(tq["wte"]) == wire[:V * (E // 32) * 34]
    assert tq["wpe"].dtype == torch.bfloat16
    for jb, tb in zip(jq_plain["blocks"], tq["blocks"]):
        for grp, keys in (("attn", ("c_attn_w", "c_proj_w")),
                          ("mlp", ("c_fc_w", "c_proj_w"))):
            for key in keys:
                assert to_wire(tb[grp][key]) == \
                    qtensor_to_wire(jb[grp][key])[1], key
            assert not isinstance(tb[grp]["c_proj_b"], QTensor)
    tiny = gpt2.quantize_params(
        gpt2.init_params(gpt2.GPT2_TINY, device="cpu"), GType.Q8_0)
    assert not isinstance(tiny["wte"], QTensor)  # E 128: left float, as JAX
    tiny128 = gpt2.quantize_params(
        gpt2.init_params(gpt2.GPT2_TINY, device="cpu"), GType.Q8_0,
        min_cols=128)
    assert not isinstance(tiny128["wte"], QTensor)  # rows are not 256-groups


@pytest.mark.parametrize("name", ["GPT2_124M", "GPT2_355M", "GPT2_774M",
                                  "GPT2_TINY", "GPT2_1558M"])
def test_named_configs_match_jax(name):
    a, b = getattr(gpt2, name), getattr(jgpt2, name)
    assert (a.n_vocab, a.n_ctx, a.n_embd, a.n_head, a.n_layer, a.ln_eps,
            a.head_dim) == (b.n_vocab, b.n_ctx, b.n_embd, b.n_head,
                            b.n_layer, b.ln_eps, b.head_dim)


@pytest.mark.parametrize("batch,int8,flat", [(1, False, True),
                                             (3, False, False),
                                             (1, True, False)])
def test_new_cache_layout_rule_matches_jax(batch, int8, flat):
    tcfg, jcfg = gpt2.GPT2Config(**CFG), jgpt2.GPT2Config(**CFG)
    c = gpt2.new_cache(tcfg, batch, int8=int8, device="cpu")
    jc = jgpt2.new_cache(jcfg, batch, int8=int8)
    assert c.is_flat == flat == (jc.k[0].ndim == 3)
    assert tuple(c.k[0].shape) == tuple(jc.k[0].shape)
    assert c.int8 == int8 == jc.int8


@pytest.mark.parametrize("switch,flat", [("1", None), ("0", None),
                                         ("0", True)],
                         ids=["on", "off", "off-flat-passed"])
def test_layer_fused_switch_matches_jax(models, monkeypatch, switch, flat):
    """GGML_TPU_LAYER_FUSED read as the JAX package reads it: at 1 a b = 1
    float cache is flat and each decode step takes the whole-block route;
    at 0 new_cache gives the head-major cache, and a flat cache passed in
    takes the per-op flat route (JAX quantizes the blocks without their
    layer_fused entry then). Cache layout, the route forward calls and the
    logits (weight-only, the flat test's bar) against JAX's."""
    monkeypatch.setattr(get_config(), "quantize_activations", False)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "0")
    monkeypatch.setenv("GGML_TPU_LAYER_FUSED", switch)
    jcfg, _, jq, jq_plain, tcfg, tq = models
    # the JAX package reads the switch when it quantizes
    jtree = jq if switch == "1" else jq_plain
    kw = {} if flat is None else {"flat": flat}
    want_flat = switch == "1" or bool(flat)
    jc = jgpt2.new_cache(jcfg, 1, **kw)
    tc = gpt2.new_cache(tcfg, 1, device="cpu", **kw)
    assert tc.is_flat == (jc.k[0].ndim == 3) == want_flat
    assert tuple(tc.k[0].shape) == tuple(jc.k[0].shape)

    calls = {"jax": 0, "port": 0}

    def spy(name, mod, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, fn.__name__, wrapped)

    spy("jax", jgpt2, jgpt2._forward_wire_decode)
    spy("port", gpt2, gpt2._forward_layer_decode)
    tok, pos = np.array([[7]], np.int32), np.array([[0]], np.int32)
    jax.eval_shape(lambda p, t, c, ps: jgpt2.forward(p, jcfg, t, c, ps,
                                                     prefix_bound=64),
                   jtree, jnp.asarray(tok), jc, jnp.asarray(pos))
    with torch.inference_mode():
        gpt2.forward(tq, tcfg, torch.from_numpy(tok), tc,
                     torch.from_numpy(pos), prefix_bound=64)
    fused = switch == "1"
    assert calls == {"jax": int(fused), "port": int(fused)}, calls

    prompt = _prompt()
    toks = _prompt(n=3, seed=9)
    jlog, _ = _jax_steps(jcfg, jtree, prompt, toks, **kw)
    plog, pc = _port_steps(tcfg, tq, prompt, toks, **kw)
    assert pc.is_flat == want_flat
    np.testing.assert_allclose(plog, jlog, rtol=0, atol=2e-4)


def test_dense_and_int8_trees_take_the_unfused_routes():
    """A float tree (nothing quantized) and an INT8 cache run without the
    Q8_0 kernels' routes and agree with themselves across cache layouts."""
    cfg = gpt2.GPT2_TINY
    p = gpt2.init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                         dtype=torch.float32)
    prompt = torch.from_numpy(_prompt(n=5) % cfg.n_vocab)
    outs = []
    for kw in ({}, {"flat": False}, {"int8": True}):
        toks, cache = sampling.generate(
            gpt2.forward, cfg, p, prompt,
            gpt2.new_cache(cfg, 1, dtype=torch.float32, device="cpu", **kw), 4)
        assert int(cache.length[0]) == 9
        outs.append(toks)
    assert torch.equal(outs[0], outs[1])  # flat vs head-major, f32 rows
    assert outs[2].shape == (1, 4)


def test_synthetic_params_shapes_and_plain_route():
    """The chip run's random tree has quantize_params' layout with no f32
    weights, its blocks take the whole-block route, and plain=True gives the
    same tokens on the CPU (where every wrapper is its plain version)."""
    import functools

    from ggmlsharp_tpu_torch.kernels.gpt2_layer import block_fusable

    cfg = gpt2.GPT2Config(**CFG)
    p = gpt2.synthetic_q8_0_params(cfg, seed=1, device="cpu")
    ref = gpt2.quantize_params(gpt2.init_params(cfg, device="cpu"),
                               GType.Q8_0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (type(t).__name__, tuple(t.shape))

    assert shapes(p) == shapes(ref)
    assert all(block_fusable(b) for b in p["blocks"])
    prompt = torch.from_numpy(_prompt())
    a, _ = sampling.generate(gpt2.forward, cfg, p, prompt,
                             gpt2.new_cache(cfg, 1, device="cpu"), 4)
    b, _ = sampling.generate(functools.partial(gpt2.forward, plain=True), cfg,
                             p, prompt, gpt2.new_cache(cfg, 1, device="cpu"),
                             4)
    assert torch.equal(a, b) and a.shape == (1, 4)


def test_synthetic_stream_does_not_collapse():
    """The random tree's greedy stream keeps changing (a small ``wpe`` lets
    random blocks pull every step to one token, and a run's token checks
    would then compare a single argmax): at least half of 32 tokens are
    distinct."""
    cfg = gpt2.GPT2Config(**CFG)
    p = gpt2.synthetic_q8_0_params(cfg, seed=0, device="cpu")
    toks, _ = sampling.generate(gpt2.forward, cfg, p,
                                torch.from_numpy(_prompt()),
                                gpt2.new_cache(cfg, 1, device="cpu"), 32)
    assert len(set(toks[0].tolist())) >= 16


@pytest.mark.parametrize("batch", [1, 3])
def test_flat_writer_with_a_hoisted_index(batch):
    """update_layer_flat given flat_index(cache, positions), as a forward
    hands it to every layer, writes what it writes from the positions
    alone: the named rows of each slot, nothing else."""
    from ggmlsharp_tpu_torch.models import kv_cache as kvc

    rng = np.random.default_rng(3)
    E, T, S = 128, 16, 2
    rows = [torch.from_numpy(rng.standard_normal((batch, S, E))
                             .astype(np.float32)) for _ in range(2)]
    pos = torch.from_numpy(np.stack([np.array([b + 1, b + 7], np.int32)
                                     for b in range(batch)]))
    caches = [kvc.init_cache(1, batch, 2, T, E // 2, dtype=torch.float32,
                             flat=True, device="cpu") for _ in range(2)]
    kvc.update_layer_flat(caches[0], 0, *rows, pos)
    kvc.update_layer_flat(caches[1], 0, *rows, pos,
                          kvc.flat_index(caches[1], pos))
    want = torch.zeros((batch, T, E))
    for b in range(batch):
        want[b, pos[b].long()] = rows[0][b]
    assert torch.equal(caches[0].k[0], want)
    for a, b in zip(caches[0].k + caches[0].v, caches[1].k + caches[1].v):
        assert torch.equal(a, b)


def test_set_defines_names_another_library():
    """A kernel's -D macros enter its library's name, so a probe's variant
    never loads the default build; () restores the default name."""
    from ggmlsharp_tpu_torch.kernels import _build, set_defines

    base = _build.library_path("gpt2_layer")
    other = _build.library_path("mlp_fused_q8")
    try:
        set_defines("gpt2_layer", ("LAYER_CHUNKS=4",))
        assert _build.library_path("gpt2_layer") != base
        assert _build.library_path("mlp_fused_q8") == other
    finally:
        set_defines("gpt2_layer")
    assert _build.library_path("gpt2_layer") == base
