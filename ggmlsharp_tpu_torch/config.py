"""Runtime switches read from the environment (port of the part of
ggmlsharp_tpu/config.py that the llama and serving paths read)."""
from __future__ import annotations

import os


def _env_bool(name, default):
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "False", "")


def quantize_activations() -> bool:
    """GGML_TPU_QUANT_ACTS (default on): ggml quantizes activations to the
    weight format's Q8 companion type before every quantized matmul;
    0 gives weight-only quantization."""
    return _env_bool("GGML_TPU_QUANT_ACTS", True)


def int8_kv() -> bool:
    """GGML_TPU_INT8_KV (default off): the serving engine's KV cache holds
    int8 rows with per-(token, head) absmax scales."""
    return _env_bool("GGML_TPU_INT8_KV", False)


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


def int_dot() -> bool:
    """GGML_TPU_INT_DOT (default off): a matmul of one activation row, with
    the activations quantized and Q8_0, Q4_0, Q4_1, Q5_0 or Q5_1 weights,
    runs ggml's exact integer dot (kernels.matmul_q.int_dot_matmul). On only
    for the value "1", as in the JAX package."""
    return os.environ.get("GGML_TPU_INT_DOT", "0") == "1"
