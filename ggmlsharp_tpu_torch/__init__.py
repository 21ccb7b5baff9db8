"""ggmlsharp_tpu_torch — the PyTorch/CUDA port of ggmlsharp_tpu.

Plain tensor code is PyTorch; the kernels the JAX package wrote in Pallas
for the TPU are CUDA C++ kernels for Hopper (``csrc/``), built with nvcc at
first use and bound with ctypes (``kernels/_build.py``). Every kernel keeps
its plain PyTorch version beside it: a wrapper runs the plain version for a
CPU tensor and launches the kernel (or raises) for a CUDA tensor.

Device rule: entry points take ``device=`` and default to the card
(``torch.device("cuda")``). Without a card they raise unless the caller
asked for the CPU (``device="cpu"``).
"""

from .device import resolve_device
from .dtypes import (GType, TYPE_TRAITS, block_size, is_quantized, type_name,
                     type_size)
from .quant.formats import QTensor
from .quant.quantize import dequantize, quantize

__all__ = [
    "GType",
    "QTensor",
    "TYPE_TRAITS",
    "block_size",
    "dequantize",
    "is_quantized",
    "quantize",
    "resolve_device",
    "type_name",
    "type_size",
]
