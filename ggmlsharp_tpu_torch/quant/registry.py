"""Format registry: each block format's quantizer, dequantizer, activation
dot type and kernels (port of ggmlsharp_tpu/quant/registry.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..dtypes import GType, TYPE_TRAITS
from .quantize import _DEQUANTIZE, _QUANTIZE


@dataclass(frozen=True)
class FormatEntry:
    quantize_row: Callable
    dequantize_row: Callable
    vec_dot_type: "GType | None"  # activation-side format of the dot
    has_fused_matmul: bool  # a CUDA dequant-matmul kernel takes its weights
    has_int_dot: bool  # the exact integer-dot kernel takes its weights


def _entry(g: GType) -> FormatEntry:
    from ..kernels.matmul_q import INT_DOT_FORMATS, KERNEL_OF

    return FormatEntry(
        quantize_row=_QUANTIZE[g],
        dequantize_row=_DEQUANTIZE[g],
        vec_dot_type=TYPE_TRAITS[g].vec_dot_type,
        has_fused_matmul=g in KERNEL_OF,
        has_int_dot=g in INT_DOT_FORMATS,
    )


def registry() -> dict:
    """gtype -> FormatEntry for every block format."""
    return {g: _entry(g) for g in _QUANTIZE}


def get(gtype: GType) -> FormatEntry:
    return _entry(GType(gtype))
