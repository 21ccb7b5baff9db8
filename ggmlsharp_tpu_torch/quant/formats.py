"""Block-quantized tensors in the port's own layout.

Blocks run along the last axis, as in ggml. A tensor's planes are ggml's
block fields, each field of every block gathered into one array (``_WIRE``
lists them in wire order), so the planes hold a row's wire bytes split by
field:

  * ``qs``: 4-bit formats as uint8 ``[..., K/2]`` in ggml's in-block nibble
    order (byte j of a block of B elements holds element j in its low nibble
    and element j + B/2 in its high nibble; Q4_K's 64-element groups
    likewise: byte l of group g holds elements 64g + l and 64g + 32 + l);
    Q8_0, Q8_1 and Q8_K as int8 ``[..., K]`` in element order.
  * ``d`` (and ``m``, ``s``, ``dmin``): per-block scales, float16 ``[...,
    K/B]``; Q8_1's d and s and Q8_K's d are float32, as the JAX package
    keeps them.
  * ``qh``: Q5_0/Q5_1's high bits, one int32 a block (bit l is element l's
    fifth bit); Q6_K's 2-bit high plane, uint8 ``[..., K/4]`` in ggml's
    order (byte l of a 128-element half carries elements l, l+32, l+64,
    l+96 in bit pairs 0-1, 2-3, 4-5, 6-7; ``ql`` likewise: byte l holds l
    and l+64, byte l+32 holds l+32 and l+96).
  * ``scales``: Q4_K's twelve bytes a superblock of 6-bit sub-block scales
    and mins, packed as ggml packs them; ``sc``: Q6_K's int8 sub-block
    scales; ``bsums``: Q8_K's int16 sums of 16 quants.

So ``from_wire`` / ``to_wire`` only move bytes. Q4_2 and Q4_3 (16-element
blocks) have no GGUF type id; their wire block is ggml's (f16 d, [f16 m],
8 bytes of nibbles) in the same split-half nibble order. The JAX package's
planar, storage-order, f16-pair and SWAR layouts exist for the TPU's vector
units and have no counterpart here; the two packages compute the same
function and exchange tensors as ggml wire bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import GType, TYPE_TRAITS

_U8, _I8, _F16 = np.uint8, np.int8, np.float16
# gtype -> (block elements, [(plane, wire bytes a block, wire dtype, plane
# dtype)]) in wire order; the plane dtype differs only where the JAX package
# widens a field (Q8_1's f16 d and s to f32)
_WIRE = {
    GType.Q4_0: (32, [("d", 2, _F16, _F16), ("qs", 16, _U8, _U8)]),
    GType.Q4_1: (32, [("d", 2, _F16, _F16), ("m", 2, _F16, _F16),
                      ("qs", 16, _U8, _U8)]),
    GType.Q4_2: (16, [("d", 2, _F16, _F16), ("qs", 8, _U8, _U8)]),
    GType.Q4_3: (16, [("d", 2, _F16, _F16), ("m", 2, _F16, _F16),
                      ("qs", 8, _U8, _U8)]),
    GType.Q5_0: (32, [("d", 2, _F16, _F16), ("qh", 4, np.int32, np.int32),
                      ("qs", 16, _U8, _U8)]),
    GType.Q5_1: (32, [("d", 2, _F16, _F16), ("m", 2, _F16, _F16),
                      ("qh", 4, np.int32, np.int32), ("qs", 16, _U8, _U8)]),
    GType.Q8_0: (32, [("d", 2, _F16, _F16), ("qs", 32, _I8, _I8)]),
    GType.Q8_1: (32, [("d", 2, _F16, np.float32), ("s", 2, _F16, np.float32),
                      ("qs", 32, _I8, _I8)]),
    GType.Q4_K: (256, [("d", 2, _F16, _F16), ("dmin", 2, _F16, _F16),
                       ("scales", 12, _U8, _U8), ("qs", 128, _U8, _U8)]),
    GType.Q6_K: (256, [("ql", 128, _U8, _U8), ("qh", 64, _U8, _U8),
                       ("sc", 16, _I8, _I8), ("d", 2, _F16, _F16)]),
    GType.Q8_K: (256, [("d", 4, np.float32, np.float32),
                       ("qs", 256, _I8, _I8), ("bsums", 32, np.int16,
                                                np.int16)]),
}
FORMATS = tuple(_WIRE)
_TORCH = {np.dtype(t): torch.from_numpy(np.zeros(0, t)).dtype
          for t in (_U8, _I8, _F16, np.int16, np.int32, np.float32)}


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
        """Bytes the planes hold (the ggml wire size, but for Q8_1's f32 d
        and s)."""
        return sum(p.numel() * p.element_size() for p in self.planes.values())

    def __repr__(self):
        pl = {k: (tuple(v.shape), str(v.dtype)) for k, v in self.planes.items()}
        return (f"QTensor({TYPE_TRAITS[self.gtype].name}, shape={self.shape}, "
                f"planes={pl})")


def _check_format(gtype):
    if GType(gtype) not in _WIRE:
        raise NotImplementedError(
            f"{GType(gtype).name} is not a block format")


def wire_block_bytes(gtype) -> tuple:
    """(elements, wire bytes) of one block of ``gtype``."""
    bs, fields = _WIRE[GType(gtype)]
    return bs, sum(f[1] for f in fields)


def plane_specs(gtype, k: int) -> dict:
    """{plane: (torch dtype, columns a row of k elements)} of ``gtype``."""
    bs, fields = _WIRE[GType(gtype)]
    return {name: (_TORCH[np.dtype(pdt)],
                   k // bs * nbytes // np.dtype(wdt).itemsize)
            for name, nbytes, wdt, pdt in fields}


def from_wire(gtype, wire, shape, device=None) -> QTensor:
    """ggml wire blocks (bytes or a uint8 array) -> QTensor on ``device``
    (the card unless the caller asks for another). The bytes go to the
    device in one copy; the fields are split there."""
    device = resolve_device(device)
    gtype = GType(gtype)
    _check_format(gtype)
    shape = tuple(int(s) for s in shape)
    lead, k = shape[:-1], shape[-1]
    rows = int(np.prod(lead))
    bs, fields = _WIRE[gtype]
    _, bb = wire_block_bytes(gtype)
    if k % bs:
        raise ValueError(f"{gtype.name}: row of {k} is not whole blocks")
    nb = k // bs
    raw = np.frombuffer(wire, np.uint8) if isinstance(wire, (bytes, bytearray)) \
        else np.asarray(wire, np.uint8)
    if raw.size != rows * nb * bb:
        raise ValueError(f"wire size {raw.size} does not match {shape}")
    # copied once on the host: the planes own their memory, and a
    # read-only buffer (bytes, a mapped file) cannot back a tensor
    blocks = torch.from_numpy(raw.copy()).to(device).reshape(rows, nb, bb)
    planes, off = {}, 0
    for name, nbytes, wdt, pdt in fields:
        v = blocks[:, :, off:off + nbytes].contiguous()
        planes[name] = v.view(_TORCH[np.dtype(wdt)]).to(
            _TORCH[np.dtype(pdt)]).reshape(*lead, -1)
        off += nbytes
    return QTensor(gtype, shape, planes)


def to_wire(qt: QTensor) -> bytes:
    """QTensor -> ggml wire blocks. The blocks are interleaved on the
    tensor's device and copied to the host once."""
    _check_format(qt.gtype)
    rows = int(np.prod(qt.shape[:-1]))
    bs, fields = _WIRE[qt.gtype]
    nb = qt.shape[-1] // bs
    parts = []
    for name, nbytes, wdt, _ in fields:
        v = qt[name].detach().to(_TORCH[np.dtype(wdt)]).contiguous()
        parts.append(v.view(torch.uint8).reshape(rows, nb, nbytes))
    return torch.cat(parts, dim=-1).cpu().numpy().tobytes()


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


def split_rows(t, sizes):
    """Split a 2-D QTensor or tensor into row blocks of ``sizes`` (the
    inverse of ``concat_qtensors``). The pieces are views of ``t``."""
    if sum(sizes) != t.shape[0]:
        raise ValueError(f"row sizes {sizes} do not add up to {t.shape[0]}")
    if not isinstance(t, QTensor):
        return list(torch.split(t, list(sizes), dim=0))
    out, lo = [], 0
    for n in sizes:
        out.append(QTensor(t.gtype, (n, t.shape[1]),
                           {k: v[lo:lo + n] for k, v in t.planes.items()}))
        lo += n
    return out
