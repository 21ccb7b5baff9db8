"""The ggml type system (port of ggmlsharp_tpu/dtypes.py).

GType keeps the JAX package's numbering so that types cross between the
packages by value. Traits cover the types this port implements so far:
F32, F16, BF16, Q4_0 and Q8_0.
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
    type_size_bytes: int  # ggml wire bytes per block
    is_quantized: bool
    # activation-side type of the quantized dot (ggml's vec_dot_type)
    vec_dot_type: "GType | None" = None
    torch_dtype: "torch.dtype | None" = None  # non-quantized types only


TYPE_TRAITS: dict[GType, TypeTraits] = {
    GType.F32: TypeTraits("f32", 1, 4, False, torch_dtype=torch.float32),
    GType.F16: TypeTraits("f16", 1, 2, False, torch_dtype=torch.float16),
    GType.BF16: TypeTraits("bf16", 1, 2, False, torch_dtype=torch.bfloat16),
    # 32-element blocks, one f16 scale each (modern ggml / GGUF)
    GType.Q4_0: TypeTraits("q4_0", 32, 2 + 16, True, GType.Q8_0),
    GType.Q8_0: TypeTraits("q8_0", 32, 2 + 32, True, GType.Q8_0),
}


def row_size_bytes(t: GType, n: int) -> int:
    """Wire bytes for a row of n elements (ggml_nbytes)."""
    tr = TYPE_TRAITS[t]
    if n % tr.block_size:
        raise ValueError(f"{tr.name}: row of {n} is not whole blocks")
    return n // tr.block_size * tr.type_size_bytes
