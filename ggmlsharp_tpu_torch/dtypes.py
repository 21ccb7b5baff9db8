"""The ggml type system (port of ggmlsharp_tpu/dtypes.py).

GType keeps the JAX package's numbering so that types cross between the
packages by value. Traits cover the float types (F32, F16, BF16) and every
block format: the legacy 32-element formats Q4_0, Q4_1, Q5_0, Q5_1, Q8_0,
Q8_1, their 16-element variants Q4_2 and Q4_3, and the k-quant superblocks
Q4_K, Q6_K and Q8_K (256 elements).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class GType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q4_2 = 4
    Q4_3 = 5
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    I8 = 10
    I16 = 11
    I32 = 12
    BF16 = 13
    Q4_K = 14
    Q6_K = 15
    Q8_K = 16


@dataclass(frozen=True)
class TypeTraits:
    name: str
    block_size: int  # elements per quantization block
    type_size_bytes: int  # bytes a block (ggml_type_size, as in JAX)
    is_quantized: bool
    # activation-side type of the quantized dot (ggml's vec_dot_type)
    vec_dot_type: "GType | None" = None
    torch_dtype: "torch.dtype | None" = None  # non-quantized types only


_F16 = 2
TYPE_TRAITS: dict[GType, TypeTraits] = {
    GType.F32: TypeTraits("f32", 1, 4, False, torch_dtype=torch.float32),
    GType.F16: TypeTraits("f16", 1, 2, False, torch_dtype=torch.float16),
    GType.BF16: TypeTraits("bf16", 1, 2, False, torch_dtype=torch.bfloat16),
    GType.I8: TypeTraits("i8", 1, 1, False, torch_dtype=torch.int8),
    GType.I16: TypeTraits("i16", 1, 2, False, torch_dtype=torch.int16),
    GType.I32: TypeTraits("i32", 1, 4, False, torch_dtype=torch.int32),
    # legacy blocks with f16 scales (modern ggml / GGUF)
    GType.Q4_0: TypeTraits("q4_0", 32, _F16 + 16, True, GType.Q8_0),
    GType.Q4_1: TypeTraits("q4_1", 32, 2 * _F16 + 16, True, GType.Q8_1),
    GType.Q4_2: TypeTraits("q4_2", 16, _F16 + 8, True, GType.Q8_0),
    GType.Q4_3: TypeTraits("q4_3", 16, 2 * _F16 + 8, True, GType.Q8_1),
    GType.Q5_0: TypeTraits("q5_0", 32, _F16 + 4 + 16, True, GType.Q8_0),
    GType.Q5_1: TypeTraits("q5_1", 32, 2 * _F16 + 4 + 16, True, GType.Q8_1),
    GType.Q8_0: TypeTraits("q8_0", 32, _F16 + 32, True, GType.Q8_0),
    # activation side; f32 d and s (the wire block carries them as f16)
    GType.Q8_1: TypeTraits("q8_1", 32, 4 + 4 + 32, True, GType.Q8_1),
    # k-quant superblocks (llama.cpp)
    GType.Q4_K: TypeTraits("q4_K", 256, 2 * _F16 + 12 + 128, True, GType.Q8_K),
    GType.Q6_K: TypeTraits("q6_K", 256, 128 + 64 + 16 + _F16, True,
                           GType.Q8_K),
    GType.Q8_K: TypeTraits("q8_K", 256, 4 + 256 + 16 * 2, True, GType.Q8_K),
}


def type_name(t: GType) -> str:
    return TYPE_TRAITS[t].name


def block_size(t: GType) -> int:
    return TYPE_TRAITS[t].block_size


def type_size(t: GType):
    """Bytes of one block (of one element for the float types), as the
    traits table writes it."""
    return TYPE_TRAITS[t].type_size_bytes


def is_quantized(t: GType) -> bool:
    return TYPE_TRAITS[t].is_quantized


def row_size_bytes(t: GType, n: int) -> int:
    """Bytes of a row of n elements (ggml_nbytes); the wire size of every
    format but Q8_1, whose wire block holds f16 d and s (quant.formats)."""
    tr = TYPE_TRAITS[t]
    if n % tr.block_size:
        raise ValueError(f"{tr.name}: row of {n} is not whole blocks")
    return n // tr.block_size * tr.type_size_bytes
