"""Communication overlapped with the row-parallel dequant-matmul (port of
ggmlsharp_tpu/parallel/overlap.py).

A row-parallel matmul (weights K-sharded over ``model``) needs the ranks'
partial outputs summed. Rather than one full local matmul followed by one
all-reduce, the local matmul splits into D output-row tiles and a ring
reduce-scatter runs beside them: each hop's isend/irecv is issued before
the next tile's dequant-matmul is launched, and waited for after it.

    acc = C(t_0)                       # this rank's first tile
    for s in 0..D-2:
        start = ppermute_start(acc)    # the hop in flight ...
        nxt   = C(t_{s+1})             # ... while this tile runs
        acc   = start.wait() + nxt

The tiles are ``ops.mul_mat`` of a row slice of the shard: kernel 1 (or
the format's dequant-matmul) on the card, the plain version on the CPU or
with ``use_kernels=False``. JAX's per-chunk planar repack
(``repack_k_chunks``) has no counterpart: the port's planes are blocked
along K, so a K-shard is a plain slice of each plane.
"""
from __future__ import annotations

import torch

from .. import ops
from ..quant.formats import QTensor
from . import comm
from .sharding import row_shard


def _slice_rows(w, start: int, size: int):
    if isinstance(w, QTensor):
        return QTensor(w.gtype, (size, w.shape[1]),
                       {k: v[start:start + size] for k, v in w.planes.items()})
    return w[start:start + size]


def ring_reduce_scatter_mul_mat(w_local, x_local, ax: comm.Axis,
                                use_kernels: bool | None = None):
    """Row-parallel matmul with the reduce-scatter ring overlapped against
    the tiles. w_local: this rank's K-shard [N, K/D] (QTensor or tensor);
    x_local [..., K/D]. Returns this rank's finished output tile
    [..., N/D] and its tile index ((rank + 1) mod D, the ring's landing
    order)."""
    D, idx = ax.size, ax.rank
    n = w_local.shape[0]
    if n % D:
        raise ValueError(f"{n} output rows do not split into {D} tiles")
    ntile = n // D
    plain = use_kernels is False

    def C(j):
        return ops.mul_mat(_slice_rows(w_local, j * ntile, ntile), x_local,
                           quantize_acts=False, plain=plain)

    acc = C(idx % D)
    for s in range(D - 1):
        hop = comm.ppermute_start(acc, ax, 1)  # comm in flight ...
        nxt = C((idx - 1 - s) % D)             # ... while this runs
        acc = hop.wait() + nxt
    return acc, (idx + 1) % D


def row_parallel_mul_mat_overlapped(w, x, mesh, axis: str = "model",
                                    use_kernels: bool | None = None):
    """The whole function on every rank: w [N, K] and x [..., K], the same
    on every rank of ``axis``; each rank takes its K-shard of both (block
    boundaries for a QTensor), runs the ring and gathers the finished
    tiles. Returns y = x·wᵀ [..., N] on every rank."""
    ax = comm.axis(mesh, axis)
    D = ax.size
    w_l = row_shard(w, ax.rank, D, "w")
    k = x.shape[-1] // D
    x_l = x[..., ax.rank * k:(ax.rank + 1) * k].contiguous()
    acc, _ = ring_reduce_scatter_mul_mat(w_l, x_l, ax, use_kernels)
    y = comm.all_gather(acc[None], ax, 0)  # [D, ..., N/D]
    # rank d finished tile (d + 1) mod D: rank order is [t1, ..., t0]
    y = torch.roll(y, 1, dims=0)
    return torch.movedim(y, 0, -2).reshape(*y.shape[1:-1], -1)
