"""The op surface of the JAX package's ``ops``: everything the reference
implements plus what it declares but stubs (get_rows, diag_mask_inf,
soft_max, rope, alibi, conv_1d_*, flash_attn, flash_ff, map_unary/binary)."""

from .attention import (
    NEG_INF,
    alibi,
    alibi_slopes,
    diag_mask_inf,
    flash_attn,
    flash_ff,
    rope,
    rope_n_past,
    soft_max,
)
from .basic import (
    abs_,
    add,
    cont,
    cpy,
    div,
    dup,
    gelu,
    map_binary,
    map_unary,
    max_,
    mean,
    mul,
    neg,
    norm,
    permute,
    relu,
    repeat,
    repeat_back,
    reshape,
    rms_norm,
    scale,
    sgn,
    silu,
    sqr,
    sqrt,
    step,
    sub,
    sum_,
    transpose,
    view,
)
from .conv import conv_1d_1s, conv_1d_2s
from .embedding import get_rows
from .matmul import mul_mat, mul_mat_f, mul_mat_q, out_prod, quantize_activations

__all__ = [
    "NEG_INF", "abs_", "add", "alibi", "alibi_slopes", "cont", "conv_1d_1s",
    "conv_1d_2s", "cpy", "diag_mask_inf", "div", "dup", "flash_attn",
    "flash_ff", "gelu", "get_rows", "map_binary", "map_unary", "max_", "mean",
    "mul", "mul_mat", "mul_mat_f", "mul_mat_q", "neg", "norm", "out_prod",
    "permute", "quantize_activations", "relu", "repeat", "repeat_back",
    "reshape", "rms_norm", "rope", "rope_n_past", "scale", "sgn", "silu",
    "soft_max", "sqr", "sqrt", "step", "sub", "sum_", "transpose", "view",
]
