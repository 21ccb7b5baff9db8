"""get_rows, the embedding lookup (port of ggmlsharp_tpu/ops/embedding.py).

A quantized table gathers the rows' blocks first and dequantizes only
those rows: a 32000 x 4096 table is never expanded whole."""
from __future__ import annotations

from ..quant.formats import QTensor
from ..quant.quantize import dequantize


def get_rows(table, ids):
    """table: [vocab, d] tensor or QTensor; ids: int [...] -> [..., d]."""
    ids = ids.long()
    if isinstance(table, QTensor):
        if len(table.shape) != 2:
            raise ValueError(f"get_rows needs a 2-D table, got {table.shape}")
        planes = {k: v[ids] for k, v in table.planes.items()}
        return dequantize(QTensor(table.gtype, (*ids.shape, table.shape[-1]),
                                  planes))
    return table[ids]
