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
