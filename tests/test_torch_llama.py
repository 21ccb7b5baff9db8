"""The port's llama slice against the JAX package on the CPU.

Weights cross as ggml wire bytes (io.gguf.qtensor_to_wire ->
llama.params_from_jax), so both packages hold bit-identical parameters. The
config quantizes every matmul weight (n_embd 256; TINY_LLAMA's 128 would
leave them dense). A 12-token prompt makes prefill take the flash branch
(S > 8), then 8 greedy tokens ride the einsum decode branch.

Tolerances:
  * weight-only quantization (GGML_TPU_QUANT_ACTS=0): the two packages
    differ only in f32 summation order and libm ulps: 1e-4 on logits of
    magnitude ~1;
  * with the Q8_0 activation round trip (the default), an f32 input that
    differs by one ulp can move one activation by a whole Q8 step
    (amax/127); over two layers that came to 6e-3..9e-3 on logits of
    magnitude ~1 for three seeds: 2e-2.
Greedy tokens must agree wherever the JAX top-2 logit gap exceeds the
tolerance (a smaller gap may fairly flip, and the runs part from there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.models import kv_cache as jkvc
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import kv_cache as kvc
from ggmlsharp_tpu_torch.models import llama, sampling
from ggmlsharp_tpu_torch.quant.formats import QTensor, to_wire


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package: its matmuls multiply f32 operands exactly on the CPU in
    either of its modes (DEFAULT precision is f32 there). The port's "bf16"
    function is held against JAX in test_torch_mm_dot.py."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


CFG = dict(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_head_kv=2,
           n_layer=2, n_ff=512)
PROMPT_LEN, N_NEW = 12, 8


def to_port_tree(x):
    """JAX parameter tree -> numpy / (gtype, wire bytes, shape) leaves."""
    if isinstance(x, JQTensor):
        g, wire = qtensor_to_wire(x)
        return (int(g), wire, x.shape)
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_port_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port_tree(v) for v in x]
    return np.asarray(x)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**CFG)
    raw = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    jq = jllama.quantize_params(raw, JGType.Q4_0, swar=False)
    tq = llama.params_from_jax(to_port_tree(jq), device="cpu")
    return jcfg, raw, jq, llama.LlamaConfig(**CFG), tq


def _prompt():
    rng = np.random.default_rng(0)
    return rng.integers(0, CFG["n_vocab"], (1, PROMPT_LEN)).astype(np.int32)


def _jax_run(jcfg, jq):
    """JAX greedy tokens, the prefill logits and the logits that chose each
    token (one forward over prompt + tokens: flash prefill numerics)."""
    prompt = jnp.asarray(_prompt())
    toks, _ = jsampling.generate(jllama.forward, jcfg, jq, prompt,
                                 jllama.new_cache(jcfg, 1), N_NEW)
    toks = np.asarray(toks)
    seq = np.concatenate([_prompt(), toks[:, :-1]], axis=1)
    S = seq.shape[1]
    fwd = jax.jit(lambda p, t, c, pos: jllama.forward(
        p, jcfg, t, c, pos, prefix_bound=jcfg.n_ctx)[0])
    pos = jnp.arange(S, dtype=jnp.int32)[None]
    logits = np.asarray(fwd(jq, jnp.asarray(seq), jllama.new_cache(jcfg, 1),
                            pos))
    return toks, logits[0, PROMPT_LEN - 1:]


def _port_run(tcfg, tq):
    prompt = torch.from_numpy(_prompt())
    with torch.inference_mode():
        pre, _ = llama.forward(tq, tcfg, prompt,
                               llama.new_cache(tcfg, 1, device="cpu"),
                               torch.arange(PROMPT_LEN,
                                            dtype=torch.int32)[None],
                               prefix_bound=tcfg.n_ctx)
    toks, cache = sampling.generate(llama.forward, tcfg, tq, prompt,
                                    llama.new_cache(tcfg, 1, device="cpu"),
                                    N_NEW)
    assert int(cache.length[0]) == PROMPT_LEN + N_NEW
    return toks.numpy(), pre[0, -1].numpy()


def _check_tokens(jtoks, ptoks, jlogits, tol):
    """Each port token is a JAX argmax up to ``tol``, so the tokens agree
    wherever the JAX top-2 gap exceeds ``tol``. After a (near-tie) flip the
    two runs feed different tokens and the comparison stops."""
    for i in range(N_NEW):
        row = jlogits[i]
        assert row[ptoks[0, i]] >= row.max() - tol, f"token {i}"
        if ptoks[0, i] != jtoks[0, i]:
            break


@pytest.mark.parametrize("quant_acts,tol", [(False, 1e-4), (True, 2e-2)])
def test_slice_matches_jax(models, monkeypatch, quant_acts, tol):
    jcfg, _, jq, tcfg, tq = models
    monkeypatch.setattr(get_config(), "quantize_activations", quant_acts)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if quant_acts else "0")
    jtoks, jlogits = _jax_run(jcfg, jq)
    ptoks, plogits = _port_run(tcfg, tq)
    np.testing.assert_allclose(plogits, jlogits[0], rtol=0, atol=tol)
    _check_tokens(jtoks, ptoks, jlogits, tol)


@pytest.mark.parametrize("quant_acts,tol", [(False, 1e-4), (True, 2e-2)])
def test_default_mm_dot_bf16_slice_matches_jax(models, monkeypatch,
                                               quant_acts, tol):
    """The port in its default mm_dot ("bf16") against JAX at the bf16
    noise bar carried through the layers (test_torch_gpt2.bf16_noise_bar);
    the mode must reach the model: its logits move from the "f32" run's
    (weight-only, by more than the f32 bar)."""
    from test_torch_gpt2 import bf16_noise_bar

    jcfg, _, jq, tcfg, tq = models
    monkeypatch.setattr(get_config(), "quantize_activations", quant_acts)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if quant_acts else "0")
    jtoks, jlogits = _jax_run(jcfg, jq)
    _, f32_logits = _port_run(tcfg, tq)
    monkeypatch.setattr(kcfg, "_mm_dot", None)
    assert kcfg.mm_dot_mode() == "bf16"
    ptoks, plogits = _port_run(tcfg, tq)
    bar = bf16_noise_bar(jlogits, tol, CFG["n_layer"])
    assert bool((np.abs(plogits - jlogits[0]) <= bar[0]).all()), \
        float((np.abs(plogits - jlogits[0]) / bar[0]).max())
    assert np.abs(plogits - f32_logits).max() > (0.0 if quant_acts else tol)
    _check_tokens(jtoks, ptoks, jlogits, float(bar.max()))


def test_quantize_params_matches_jax(models):
    """The port's own quantize_params (padding, fusing) gives the JAX
    package's wire bytes for every quantized leaf."""
    _, raw, jq, tcfg, _ = models
    raw_t = llama.params_from_jax(to_port_tree(raw), device="cpu")
    tq = llama.quantize_params(raw_t, GType.Q4_0)
    for name in ("tok_embd", "output"):
        assert tq[name].shape == jq[name].shape
        assert to_wire(tq[name]) == qtensor_to_wire(jq[name])[1]
    for jb, tb in zip(jq["blocks"], tq["blocks"]):
        assert set(jb) == set(tb)
        for key, leaf in tb.items():
            if isinstance(leaf, QTensor):
                assert to_wire(leaf) == qtensor_to_wire(jb[key])[1], key
            else:
                assert torch.equal(leaf.float(),
                                   torch.from_numpy(np.asarray(
                                       jb[key], np.float32)))


def test_params_from_jax_keeps_bf16_bits(models):
    _, raw, _, _, _ = models
    t = llama.params_from_jax(to_port_tree(raw), device="cpu")
    assert t["tok_embd"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["tok_embd"].float().numpy(),
                                  np.asarray(raw["tok_embd"], np.float32))


def test_kv_cache_update_read_matches_jax():
    """Rows land at the same positions per batch slot; reads cast to f32."""
    rng = np.random.default_rng(5)
    k_new = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    v_new = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    pos = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    jc = jkvc.update_layer(jkvc.init_cache(1, 2, 2, 16, 8), 0,
                           jnp.asarray(k_new), jnp.asarray(v_new),
                           jnp.asarray(pos))
    tc = kvc.update_layer(kvc.init_cache(1, 2, 2, 16, 8, device="cpu"), 0,
                          torch.from_numpy(k_new), torch.from_numpy(v_new),
                          torch.from_numpy(pos))
    jk, jv = jkvc.read_layer(jc, 0)
    tk, tv = kvc.read_layer(tc, 0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(kvc.advance(tc, 3).length[1]) == 3


@pytest.mark.parametrize("n,max_len", [(1, 2048), (256, 2048), (257, 2048),
                                       (600, 1000), (16, 128)])
def test_length_bucket_matches_jax(n, max_len):
    assert sampling.length_bucket(n, max_len) == \
        jsampling.length_bucket(n, max_len)


def test_synthetic_params_shapes():
    """The chip run's random tree has the fused layout quantize_params
    gives, without any f32 weights."""
    cfg = llama.LlamaConfig(**CFG)
    p = llama.synthetic_q4_0_params(cfg, seed=1, device="cpu")
    ref = llama.quantize_params(llama.init_params(cfg, device="cpu"),
                                GType.Q4_0)
    assert p["tok_embd"].shape == ref["tok_embd"].shape
    for pb, rb in zip(p["blocks"], ref["blocks"]):
        assert {k: tuple(v.shape) for k, v in pb.items()} == \
            {k: tuple(v.shape) for k, v in rb.items()}
    toks, _ = sampling.generate(llama.forward, cfg, p,
                                torch.tensor([[1, 2, 3]], dtype=torch.int32),
                                llama.new_cache(cfg, 1, device="cpu"), 2)
    assert toks.shape == (1, 2)
