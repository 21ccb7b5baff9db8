from .formats import QTensor, concat_qtensors, from_wire, split_rows, to_wire
from .quantize import dequantize, quantize

__all__ = ["QTensor", "concat_qtensors", "dequantize", "from_wire",
           "quantize", "split_rows", "to_wire"]
