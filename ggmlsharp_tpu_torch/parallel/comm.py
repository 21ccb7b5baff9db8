"""The collectives the port's models issue (the port's own module: GSPMD
inserts these in the JAX package).

Every rank holds its local shard as a plain tensor or QTensor, and the
models call the functions below where GSPMD would put a collective. ``ax``
is an ``Axis`` (one mesh dimension as this rank sees it); ``ax=None`` means
no mesh, and then every function is the identity.

gloo takes CUDA tensors for only some collectives (not send/recv), so for a
gloo group every collective on a CUDA tensor goes through a pinned host
buffer: copied down, reduced or exchanged on the host, copied back. The
choice is made from the group's backend name. ``STAGED["bytes"]`` counts
the bytes those copies move (down and back); NCCL groups stage nothing.

Training: ``copy_to`` (identity forward, all-reduce backward) and
``reduce_from`` (all-reduce forward, identity backward) are Megatron's f
and g; ``gather_from`` gathers forward and takes this rank's slice of the
gradient backward.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

STAGED = {"bytes": 0}


def reset_staged():
    STAGED["bytes"] = 0


class Axis:
    """One dimension of a device mesh as this rank sees it: its process
    group, this rank's index on it, its size and its backend name."""

    def __init__(self, group, rank: int, size: int, backend: str,
                 name: str = "model"):
        self.group, self.rank, self.size = group, rank, size
        self.backend, self.name = backend, name

    def global_rank(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def __repr__(self):
        return (f"Axis({self.name!r}, rank {self.rank} of {self.size}, "
                f"{self.backend})")


def axis(mesh, name: str) -> Axis:
    """The Axis of dimension ``name`` of a DeviceMesh for this rank."""
    group = mesh.get_group(name)
    size = mesh.size(mesh.mesh_dim_names.index(name))
    return Axis(group, mesh.get_local_rank(name), size,
                str(dist.get_backend(group)), name)


def _staged(x: torch.Tensor, ax: Axis) -> bool:
    return ax.backend == "gloo" and x.is_cuda


def _down(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    STAGED["bytes"] += h.numel() * h.element_size()
    return h


def _up(h: torch.Tensor, device) -> torch.Tensor:
    STAGED["bytes"] += h.numel() * h.element_size()
    return h.to(device, non_blocking=True)


def all_reduce(x: torch.Tensor, ax: Axis | None) -> torch.Tensor:
    """The sum of x over the axis (a new tensor; x is left as it is)."""
    if ax is None:
        return x
    if _staged(x, ax):
        h = _down(x)
        dist.all_reduce(h, group=ax.group)
        return _up(h, x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=ax.group)
    return y


def all_gather(x: torch.Tensor, ax: Axis | None, dim: int = -1
               ) -> torch.Tensor:
    """The axis' shards of x concatenated along ``dim`` in rank order."""
    if ax is None:
        return x
    src = _down(x) if _staged(x, ax) else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    out = torch.cat(parts, dim=dim)
    return _up(out, x.device) if _staged(x, ax) else out


class Pending:
    """An exchange in flight (``ppermute_start``); ``wait()`` returns the
    tensor received."""

    def __init__(self, reqs, buf, device, staged):
        self._reqs, self._buf = reqs, buf
        self._device, self._staged = device, staged

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        return _up(self._buf, self._device) if self._staged else self._buf


def ppermute_start(x: torch.Tensor, ax: Axis, shift: int = 1) -> Pending:
    """Send x to rank (r + shift) mod n of the axis and receive the tensor
    of rank (r - shift) mod n, both issued now (isend/irecv). On one rank
    the tensor received is x itself."""
    n = ax.size
    if n == 1:
        done = x.detach().clone(memory_format=torch.contiguous_format)
        return Pending([], done, x.device, False)
    staged = _staged(x, ax)
    send = _down(x) if staged else x.detach().contiguous()
    buf = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ax.global_rank((ax.rank + shift) % n),
                      ax.group),
           dist.P2POp(dist.irecv, buf, ax.global_rank((ax.rank - shift) % n),
                      ax.group)]
    return Pending(dist.batch_isend_irecv(ops), buf, x.device, staged)


def ppermute(x: torch.Tensor, ax: Axis, shift: int = 1) -> torch.Tensor:
    """jax.lax.ppermute over the ring of the axis: rank r receives the x of
    rank (r - shift) mod n."""
    return ppermute_start(x, ax, shift).wait()


def psum(value: float, ax: Axis | None) -> float:
    """A host scalar summed over the axis (in f64)."""
    if ax is None:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    if ax.backend != "gloo":
        t = t.cuda()
    dist.all_reduce(t, group=ax.group)
    return float(t[0])


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.rank * ctx.n, ctx.n), None, None


def _tracks(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x, ax: Axis | None):
    """The input of a column-parallel matmul: x forward, the gradient
    summed over the axis backward."""
    if ax is None or not _tracks(x):
        return x
    return _CopyTo.apply(x, ax)


def reduce_from(x, ax: Axis | None):
    """The output of a row-parallel matmul: summed over the axis forward,
    the gradient as it is backward."""
    if ax is None:
        return x
    if not _tracks(x):
        return all_reduce(x, ax)
    return _ReduceFrom.apply(x, ax)


def gather_from(x, ax: Axis | None, dim: int = -1):
    """Shards concatenated along ``dim`` forward; this rank's slice of the
    gradient backward."""
    if ax is None:
        return x
    dim = dim % x.dim()
    if not _tracks(x):
        return all_gather(x, ax, dim)
    return _GatherFrom.apply(x, ax, dim)
