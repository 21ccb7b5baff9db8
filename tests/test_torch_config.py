"""The port's config layer against the JAX package's on the CPU:
RuntimeConfig from the environment, apply() and the kernel switches,
LLAMA_13B, and GGML_TPU_ATTN's four routes through a small llama.

Tolerance of the GGML_TPU_ATTN comparison: the model is float (E 64 leaves
no weight quantized) with f32 weights and an f32 cache, so the two packages
differ only in f32 summation order and libm ulps: 1e-4 on the logits, the
weight-only bar of test_torch_llama.py. The JAX model runs eagerly (no jit
cache keyed on another route) and its flash kernel in interpret mode, as
its own tests run it on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import config as jconfig
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu_torch import GType, config
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import llama
from ggmlsharp_tpu_torch.quant import quantize

ENVS = [
    {},
    {"GGML_TPU_MM_DOT": "f32", "GGML_TPU_BATCH_SLOTS": "8",
     "GGML_TPU_INT8_KV": "1", "GGML_TPU_QUANT_ACTS": "0"},
    {"GGML_TPU_MESH_DATA": "2", "GGML_TPU_MESH_MODEL": "4",
     "GGML_TPU_INT8_KV": "false", "GGML_TPU_QUANT_ACTS": "1"},
    {"GGML_TPU_MESH_DATA": "", "GGML_TPU_BATCH_SLOTS": "16",
     "GGML_TPU_INT8_KV": "0"},
]
VARS = ("GGML_TPU_MM_DOT", "GGML_TPU_MESH_DATA", "GGML_TPU_MESH_MODEL",
        "GGML_TPU_BATCH_SLOTS", "GGML_TPU_INT8_KV", "GGML_TPU_QUANT_ACTS")


@pytest.fixture
def switches(monkeypatch):
    """Both packages' switches restored after the test."""
    for mod, names in ((jconfig, ("_config",)),
                       (jkcfg, ("_override", "_mm_dot")),
                       (config, ("_config",)),
                       (kcfg, ("_override", "_mm_dot"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    return monkeypatch


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_runtime_config_from_env_matches_jax(monkeypatch, env):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    for var, val in ENVS[env].items():
        monkeypatch.setenv(var, val)
    j = dataclasses.asdict(jconfig.RuntimeConfig())
    p = dataclasses.asdict(config.RuntimeConfig())
    assert j.pop("use_pallas") is None and p.pop("use_kernels") is None
    assert p == j
    assert set(f.name for f in dataclasses.fields(config.RuntimeConfig)) \
        == set(f.name for f in dataclasses.fields(jconfig.RuntimeConfig)) \
        - {"use_pallas"} | {"use_kernels"}


@pytest.mark.parametrize("use,mode", [(False, "f32"), (True, "bf16"),
                                      (None, "f32")])
def test_apply_moves_the_kernel_switches_as_jax(switches, use, mode):
    jconfig.set_config(jconfig.RuntimeConfig(use_pallas=use, mm_dot=mode))
    config.set_config(config.RuntimeConfig(use_kernels=use, mm_dot=mode))
    # auto: the JAX package's kernels need a TPU, the port's a card
    assert kcfg.kernels_enabled() == jkcfg.pallas_enabled()
    assert kcfg.kernels_setting() is use
    assert kcfg.mm_dot_mode() == jkcfg.mm_dot_mode() == mode
    assert config.get_config().mm_dot == mode


def test_set_config_drives_the_switch_functions(switches):
    switches.setenv("GGML_TPU_QUANT_ACTS", "1")
    assert config.quantize_activations()
    config.set_config(config.RuntimeConfig(quantize_activations=False,
                                           batch_slots=2))
    assert not config.quantize_activations() and config.batch_slots() == 2
    config.set_config(None)
    assert config.quantize_activations() and config.batch_slots() == 4


def test_mm_dot_has_one_source(switches):
    """Until set_mm_dot or apply() overrides it, the mode is the config's
    (GGML_TPU_MM_DOT), as the JAX package reads the same variable."""
    switches.setattr(kcfg, "_mm_dot", None)
    switches.setattr(config, "_config", None)
    for mode in ("f32", "bf16"):
        switches.setenv("GGML_TPU_MM_DOT", mode)
        assert kcfg.mm_dot_mode() == config.get_config().mm_dot == mode
    kcfg.set_mm_dot("f32")
    assert kcfg.mm_dot_mode() == "f32"


def test_mm_dot_and_kernel_switch_refuse_bad_values(switches):
    with pytest.raises(ValueError):
        kcfg.set_mm_dot("tf32")
    with pytest.raises(ValueError):
        kcfg.set_kernels("yes")


def _weights():
    gen = torch.Generator().manual_seed(0)
    w = quantize(torch.randn((256, 512), generator=gen), GType.Q4_K)
    x = torch.randn((2, 512), generator=gen)
    return w, x


def test_kernels_forced_on_raise_for_a_cpu_tensor(switches):
    from ggmlsharp_tpu_torch import ops
    from ggmlsharp_tpu_torch.kernels.flash import flash_attention_cached

    w, x = _weights()
    kcfg.set_kernels(True)
    with pytest.raises(RuntimeError, match="forced on"):
        ops.mul_mat(w, x)
    q = torch.randn(1, 2, 3, 32)
    with pytest.raises(RuntimeError, match="forced on"):
        flash_attention_cached(q, q, q, torch.tensor([0], dtype=torch.int32))
    kcfg.set_kernels(None)
    assert torch.equal(ops.mul_mat(w, x), ops.mul_mat(w, x, plain=True))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = property(lambda self: True)


def test_kernels_off_take_the_plain_version_for_a_card_tensor(switches):
    """set_kernels(False): a tensor on the card goes to the plain version,
    as plain=True sends it; nothing is built or launched."""
    from ggmlsharp_tpu_torch.kernels import _build
    from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused

    def no_nvcc():
        raise AssertionError("a kernel was built with kernels off")

    switches.setattr(_build, "nvcc_path", no_nvcc)
    switches.setattr(_build, "_ENTRIES", {})
    w, x = _weights()
    kcfg.set_kernels(False)
    before = dict(_build.LAUNCHES)
    got = mul_mat_q_fused(w, x.as_subclass(_OnCard))
    assert torch.equal(got.as_subclass(torch.Tensor),
                       mul_mat_q_fused(w, x, plain=True))
    assert _build.LAUNCHES == before


def test_llama_13b_matches_jax():
    assert dataclasses.asdict(llama.LLAMA_13B) == \
        dataclasses.asdict(jllama.LLAMA_13B)
    assert llama.LLAMA_13B.head_dim == jllama.LLAMA_13B.head_dim == 128


# ---- GGML_TPU_ATTN ------------------------------------------------------

CFG = dict(n_vocab=256, n_ctx=32, n_embd=64, n_head=4, n_head_kv=2,
           n_layer=2, n_ff=128)
PROMPT_LEN = 12


def to_port_tree(x):
    """A float JAX parameter tree -> numpy leaves."""
    if isinstance(x, dict):
        return {k: to_port_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port_tree(v) for v in x]
    return None if x is None else np.asarray(x)


@pytest.fixture(scope="module")
def attn_models():
    jcfg = jllama.LlamaConfig(**CFG)
    raw = jllama.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    tp = llama.params_from_jax(to_port_tree(raw), device="cpu")
    return jcfg, raw, llama.LlamaConfig(**CFG), tp


def _tokens():
    rng = np.random.default_rng(1)
    return rng.integers(0, CFG["n_vocab"], (1, PROMPT_LEN + 1)).astype(
        np.int32)


def _jax_logits(jcfg, raw):
    toks = _tokens()
    cache = jllama.new_cache(jcfg, 1, dtype=jnp.float32, flat=False)
    pos = jnp.arange(PROMPT_LEN, dtype=jnp.int32)[None]
    pre, cache = jllama.forward(raw, jcfg, jnp.asarray(toks[:, :-1]), cache,
                                pos)
    step, _ = jllama.forward(raw, jcfg, jnp.asarray(toks[:, -1:]), cache,
                             jnp.asarray([[PROMPT_LEN]], jnp.int32))
    return np.asarray(pre[0]), np.asarray(step[0])


def _port_logits(tcfg, tp):
    toks = torch.from_numpy(_tokens())
    cache = llama.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    pos = torch.arange(PROMPT_LEN, dtype=torch.int32)[None]
    with torch.inference_mode():
        pre, cache = llama.forward(tp, tcfg, toks[:, :-1], cache, pos)
        step, _ = llama.forward(tp, tcfg, toks[:, -1:], cache,
                                torch.tensor([[PROMPT_LEN]],
                                             dtype=torch.int32))
    return pre[0].numpy(), step[0].numpy()


@pytest.mark.parametrize("mode", ["auto", "einsum", "flash", "legacy"])
def test_attn_impl_matches_jax(attn_models, monkeypatch, mode):
    jcfg, raw, tcfg, tp = attn_models
    monkeypatch.setenv("GGML_TPU_ATTN", mode)
    jpre, jstep = _jax_logits(jcfg, raw)
    ppre, pstep = _port_logits(tcfg, tp)
    assert np.abs(jpre).max() > 1e-3  # the logits are not all ~0
    np.testing.assert_allclose(ppre, jpre, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pstep, jstep, rtol=0, atol=1e-4)


def test_attn_ring_raises(attn_models, monkeypatch):
    _, _, tcfg, tp = attn_models
    monkeypatch.setenv("GGML_TPU_ATTN", "ring")
    with pytest.raises(NotImplementedError, match="parallel layer"):
        _port_logits(tcfg, tp)
    monkeypatch.setenv("GGML_TPU_ATTN", "sliding")
    with pytest.raises(ValueError, match="GGML_TPU_ATTN"):
        _port_logits(tcfg, tp)
