"""Block-quantized tensors in the port's own layout.

Blocks run along the last axis, 32 elements each, as in ggml. The planes
are ggml's block fields split into two arrays:

  * ``qs``: Q4_0 as uint8 ``[..., K/2]`` in ggml's in-block nibble order
    (byte j of a block holds element j in its low nibble and element j+16
    in its high nibble); Q8_0 as int8 ``[..., K]`` in element order.
  * ``d``: the per-block scale, float16 ``[..., K/32]``.

So a row's ``qs`` bytes are exactly the payload bytes of its wire blocks.
The JAX package's planar, storage-order and SWAR layouts exist for the
TPU's vector units and have no counterpart here; the two packages compute
the same function and exchange tensors as ggml wire bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import GType, TYPE_TRAITS, row_size_bytes

_FORMATS = (GType.Q4_0, GType.Q8_0)


class QTensor:
    """A block-quantized tensor: gtype, logical shape and its planes."""

    __slots__ = ("gtype", "shape", "planes")

    def __init__(self, gtype: GType, shape, planes: dict):
        self.gtype = GType(gtype)
        self.shape = tuple(int(s) for s in shape)
        self.planes = dict(planes)

    def __getitem__(self, k):
        return self.planes[k]

    def to(self, device) -> "QTensor":
        return QTensor(self.gtype, self.shape,
                       {k: v.to(device) for k, v in self.planes.items()})

    def nbytes(self) -> int:
        """Bytes the planes hold (equal to the ggml wire size)."""
        return sum(p.numel() * p.element_size() for p in self.planes.values())

    def __repr__(self):
        pl = {k: (tuple(v.shape), str(v.dtype)) for k, v in self.planes.items()}
        return (f"QTensor({TYPE_TRAITS[self.gtype].name}, shape={self.shape}, "
                f"planes={pl})")


def _check_format(gtype):
    if GType(gtype) not in _FORMATS:
        raise NotImplementedError(f"{GType(gtype).name} is not ported yet")


def from_wire(gtype, wire, shape, device=None) -> QTensor:
    """ggml wire blocks (bytes or a uint8 array) -> QTensor on ``device``
    (the card unless the caller asks for another)."""
    device = resolve_device(device)
    gtype = GType(gtype)
    _check_format(gtype)
    shape = tuple(int(s) for s in shape)
    k = shape[-1]
    rows = int(np.prod(shape[:-1]))
    nb = k // 32
    bb = TYPE_TRAITS[gtype].type_size_bytes
    raw = np.frombuffer(wire, np.uint8) if isinstance(wire, (bytes, bytearray)) \
        else np.asarray(wire, np.uint8)
    if raw.size != rows * row_size_bytes(gtype, k):
        raise ValueError(f"wire size {raw.size} does not match {shape}")
    blocks = raw.reshape(rows, nb, bb)
    d = np.ascontiguousarray(blocks[:, :, 0:2]).view(np.float16)
    payload = np.ascontiguousarray(blocks[:, :, 2:]).reshape(*shape[:-1], -1)
    if gtype == GType.Q8_0:
        payload = payload.view(np.int8)
    planes = {"qs": torch.from_numpy(payload.copy()),
              "d": torch.from_numpy(d.reshape(*shape[:-1], nb).copy())}
    return QTensor(gtype, shape, planes).to(device)


def to_wire(qt: QTensor) -> bytes:
    """QTensor -> ggml wire blocks (18 bytes a block for Q4_0, 34 for Q8_0)."""
    _check_format(qt.gtype)
    k = qt.shape[-1]
    rows = int(np.prod(qt.shape[:-1]))
    nb = k // 32
    d = qt["d"].detach().cpu().numpy().reshape(rows, nb, 1).view(np.uint8)
    qs = qt["qs"].detach().cpu().numpy().view(np.uint8).reshape(rows, nb, -1)
    return np.concatenate([d, qs], axis=-1).tobytes()


def concat_qtensors(qts: list):
    """Concatenate 2-D tensors along rows (QTensors or dense tensors).
    Quantization is row-independent, so this is bit-identical to quantizing
    the concatenation: it fuses wq/wk/wv and w_gate/w_up into one matmul."""
    if not isinstance(qts[0], QTensor):
        return torch.cat(qts, dim=0)
    g, k = qts[0].gtype, qts[0].shape[-1]
    for t in qts[1:]:
        if not isinstance(t, QTensor) or t.gtype != g or t.shape[-1] != k \
                or len(t.shape) != 2:
            raise ValueError("incompatible QTensors for row-concat")
    planes = {key: torch.cat([t.planes[key] for t in qts], dim=0)
              for key in qts[0].planes}
    return QTensor(g, (sum(t.shape[0] for t in qts), k), planes)
