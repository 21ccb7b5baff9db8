"""Runtime numerics switches read from the environment (port of the part of
ggmlsharp_tpu/config.py that the llama main path reads)."""
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
