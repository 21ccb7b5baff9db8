from .attention import NEG_INF, rope
from .basic import gelu, norm, rms_norm, silu
from .embedding import get_rows
from .matmul import mul_mat, mul_mat_f, mul_mat_q, quantize_activations

__all__ = ["NEG_INF", "gelu", "get_rows", "mul_mat", "mul_mat_f", "mul_mat_q",
           "norm", "quantize_activations", "rms_norm", "rope", "silu"]
