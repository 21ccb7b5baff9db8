"""Runtime switches read from the environment (port of
ggmlsharp_tpu/config.py): one typed ``RuntimeConfig`` read from the
``GGML_TPU_*`` variables, and the per-switch functions the model and serving
paths call.

``get_config()`` returns the config installed by ``set_config`` or, until
one is installed, a config read from the environment as it is at the call
(the JAX package reads it once and keeps it). The per-switch functions below
read the installed config where there is one, else the environment at each
call, so a caller may flip ``GGML_TPU_QUANT_ACTS`` between runs.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field


def _env_bool(name, default):
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "False", "")


def _opt_int(name):
    v = os.environ.get(name)
    return int(v) if v else None


@dataclass
class RuntimeConfig:
    # kernel dispatch: None = auto (the kernel for a CUDA tensor, the plain
    # version for a CPU one); True / False force (kernels.config.set_kernels)
    use_kernels: bool | None = None
    mm_dot: str = field(
        default_factory=lambda: os.environ.get("GGML_TPU_MM_DOT", "bf16"))
    # parallelism defaults: the mesh dims make_mesh takes (carried as
    # values, as in the JAX package)
    mesh_data: int | None = field(
        default_factory=lambda: _opt_int("GGML_TPU_MESH_DATA"))
    mesh_model: int | None = field(
        default_factory=lambda: _opt_int("GGML_TPU_MESH_MODEL"))
    # serving
    batch_slots: int = field(
        default_factory=lambda: int(os.environ.get("GGML_TPU_BATCH_SLOTS",
                                                   "4")))
    int8_kv: bool = field(
        default_factory=lambda: _env_bool("GGML_TPU_INT8_KV", False))
    # numerics
    quantize_activations: bool = field(
        default_factory=lambda: _env_bool("GGML_TPU_QUANT_ACTS", True))

    def apply(self):
        """Push the settings into the per-subsystem switches."""
        from .kernels import config as kcfg

        kcfg.set_kernels(self.use_kernels)
        kcfg.set_mm_dot(self.mm_dot)
        return self


_config: RuntimeConfig | None = None


def get_config() -> RuntimeConfig:
    """The installed config, else one read from the environment now."""
    return _config if _config is not None else RuntimeConfig()


def set_config(cfg: RuntimeConfig | None) -> RuntimeConfig:
    """Install ``cfg`` and apply it; None goes back to reading the
    environment (and applies its defaults)."""
    global _config
    _config = cfg
    return get_config().apply()


def quantize_activations() -> bool:
    """GGML_TPU_QUANT_ACTS (default on): ggml quantizes activations to the
    weight format's Q8 companion type before every quantized matmul;
    0 gives weight-only quantization."""
    if _config is not None:
        return _config.quantize_activations
    return _env_bool("GGML_TPU_QUANT_ACTS", True)


@contextlib.contextmanager
def activation_rounding(on: bool):
    """Run the block with GGML_TPU_QUANT_ACTS set to ``on`` (the JAX
    package's scripts set ``get_config().quantize_activations``): the
    installed RuntimeConfig's field when there is one, else the
    environment, as ``quantize_activations`` reads them; restored after."""
    if _config is not None:
        prev = _config.quantize_activations
        _config.quantize_activations = on
        try:
            yield
        finally:
            _config.quantize_activations = prev
        return
    prev = os.environ.get("GGML_TPU_QUANT_ACTS")
    os.environ["GGML_TPU_QUANT_ACTS"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["GGML_TPU_QUANT_ACTS"]
        else:
            os.environ["GGML_TPU_QUANT_ACTS"] = prev


def int8_kv() -> bool:
    """GGML_TPU_INT8_KV (default off): the serving engine's KV cache holds
    int8 rows with per-(token, head) absmax scales."""
    if _config is not None:
        return _config.int8_kv
    return _env_bool("GGML_TPU_INT8_KV", False)


def batch_slots() -> int:
    """GGML_TPU_BATCH_SLOTS (default 4): the serving engine's slot count
    when the caller gives none."""
    return get_config().batch_slots


def mlp_fused() -> bool:
    """GGML_TPU_MLP_FUSED (default off): quantize_params marks each llama
    block whose Q4_0 MLP pair passes the gate, and forward then runs the MLP
    of up to 64 rows as one fused SwiGLU kernel call. On only for the value
    "1", as in the JAX package."""
    return os.environ.get("GGML_TPU_MLP_FUSED", "0") == "1"


def llama_fused() -> bool:
    """GGML_TPU_LLAMA_FUSED (default off): quantize_params (given cfg) packs
    each llama block for the whole-block kernel, and a b = 1 decode step over
    a flat float cache then runs one kernel call a block. On only for the
    value "1", as in the JAX package."""
    return os.environ.get("GGML_TPU_LLAMA_FUSED", "0") == "1"


def layer_fused() -> bool:
    """GGML_TPU_LAYER_FUSED (default on): GPT-2's whole-block route. On, a
    b = 1 float cache from gpt2.new_cache is flat and each single-token step
    over a flat float cache runs one kernels.gpt2_layer call a block; any
    value but "1" gives the head-major cache and the per-op route, as in the
    JAX package."""
    return os.environ.get("GGML_TPU_LAYER_FUSED", "1") == "1"


def int_dot() -> bool:
    """GGML_TPU_INT_DOT (default off): a matmul of one activation row, with
    the activations quantized and Q8_0, Q4_0, Q4_1, Q5_0 or Q5_1 weights,
    runs ggml's exact integer dot (kernels.matmul_q.int_dot_matmul). On only
    for the value "1", as in the JAX package."""
    return os.environ.get("GGML_TPU_INT_DOT", "0") == "1"


def attn_impl() -> str:
    """GGML_TPU_ATTN (default auto): the head-major cache's attention,
    models.common.cached_attention. auto: flash for more than 8 queries,
    grouped einsum otherwise; einsum: grouped einsum always; flash: the
    flash kernel always, decode included; legacy: materialised scores over
    the whole cache with K/V repeated to the query heads; ring: a prefill
    from an empty cache through parallel.ring_attention over the sequence
    mesh set_sequence_mesh installed (einsum without one)."""
    return os.environ.get("GGML_TPU_ATTN", "auto")
