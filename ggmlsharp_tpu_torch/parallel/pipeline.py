"""Pipeline parallelism over a mesh axis (port of
ggmlsharp_tpu/parallel/pipeline.py).

The L layers split into S contiguous stages, one a rank of ``axis``; the
batch into M microbatches. ``pipeline_forward`` is GPipe over S + M - 1
ticks: at tick i stage s runs microbatch i - s and sends its activations to
stage s + 1 (``comm.ppermute``, the +1 ring). ``pipeline_train_step`` is the
1F1B schedule: at tick i stage s runs the forward of microbatch i - s and
the backward of microbatch i - 2(S-1) + s, recomputing the stage's forward
from the stashed stage input (stash depth 2(S-1) + 1, independent of M);
activations go round the +1 ring, cotangents round the -1 ring, and each
stage's backward is ``torch.autograd.grad`` over its recomputed forward.

Every rank takes part in every exchange of every tick (zeros where its
stage is idle), so the ranks stay in step as the JAX scan does; a stage
skips the compute of an idle tick.
"""
from __future__ import annotations

import torch

from ..optim.tree import tree_leaves, tree_map, tree_unflatten
from . import comm


def _stage_range(L: int, S: int, s: int) -> range:
    if L % S:
        raise ValueError(f"{L} layers do not split into {S} stages")
    n = L // S
    return range(s * n, (s + 1) * n)


def _layers(layer_params, S: int, s: int) -> list:
    """Stage s's layers: a list holds one tree a layer (entries outside the
    stage may be None), any other tree stacks the layers on its leaves'
    leading axis."""
    if isinstance(layer_params, list):
        return [layer_params[i]
                for i in _stage_range(len(layer_params), S, s)]
    L = tree_leaves(layer_params)[0].shape[0]
    return [tree_map(lambda p, i=i: p[i], layer_params)
            for i in _stage_range(L, S, s)]


def _carry_dtype(x):
    return torch.promote_types(x.dtype, torch.float32) \
        if x.is_floating_point() else x.dtype


def pipeline_forward(stage_fn, layer_params, x, mesh, axis: str = "model",
                     n_micro: int | None = None):
    """x through the L layers pipelined over ``axis``; returns [B, ...] on
    every rank, equal to applying the layers in turn. stage_fn(layer, h)
    applies one layer to one microbatch; layer_params: a list of L layer
    trees or a tree whose leaves stack the layers on a leading axis (L a
    multiple of the axis size); x [B, ...], B a multiple of n_micro
    (default the axis size). Activations travel in f32 or wider."""
    ax = comm.axis(mesh, axis)
    S, s = ax.size, ax.rank
    M = n_micro or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    layers = _layers(layer_params, S, s)
    x_mb = x.reshape(M, B // M, *x.shape[1:])
    carry = _carry_dtype(x)
    results = torch.zeros((M,) + tuple(x_mb.shape[1:]), dtype=carry,
                          device=x.device)
    recv = torch.zeros(x_mb.shape[1:], dtype=carry, device=x.device)
    for i in range(S + M - 1):
        m = i - s
        if 0 <= m < M:
            h = x_mb[m] if s == 0 else recv
            for lp in layers:
                h = stage_fn(lp, h)
            out = h.to(carry)
            if s == S - 1:
                results[m] = out
        else:
            out = torch.zeros_like(recv)
        recv = comm.ppermute(out, ax, 1)
    # only the last stage holds the results: the sum gives them to all
    results = comm.all_reduce(results, ax)
    return results.reshape(B, *x.shape[1:])


def pipeline_train_step(stage_fn, loss_fn, stacked_params, x, y, mesh,
                        axis: str = "model", n_micro: int | None = None):
    """1F1B pipelined (loss, grads), equal to the sequential computation.

    stage_fn(layer, h) -> h applies one layer; loss_fn(out_mb, y_mb) is a
    microbatch's scalar loss (the total is the mean over microbatches).
    stacked_params: a tree whose leaves stack the L layers on a leading
    axis (L a multiple of the axis size); x, y [B, ...], B a multiple of
    n_micro (default the axis size). Returns (loss, grads) on every rank,
    grads in stacked_params' layout (each stage's, gathered)."""
    ax = comm.axis(mesh, axis)
    S, s = ax.size, ax.rank
    M = n_micro or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    L = tree_leaves(stacked_params)[0].shape[0]
    rng = _stage_range(L, S, s)
    local = tree_map(lambda p: p[rng.start:rng.stop].detach(),
                     stacked_params)
    leaves = tree_leaves(local)
    depth = 2 * (S - 1) + 1
    mb = B // M
    x_mb = x.reshape(M, mb, *x.shape[1:])
    y_mb = y.reshape(M, mb, *y.shape[1:])
    carry = _carry_dtype(x)

    def run_stage(ls, h):
        lp = tree_unflatten(local, ls)
        for j in range(len(rng)):
            h = stage_fn(tree_map(lambda p, j=j: p[j], lp), h)
        return h

    zeros = torch.zeros(x_mb.shape[1:], dtype=carry, device=x.device)
    recv_f, recv_g = zeros, zeros
    stash = [None] * depth
    gacc = [torch.zeros_like(p) for p in leaves]
    loss_sum = 0.0
    is_last = s == S - 1
    for i in range(M + 2 * (S - 1)):
        mf = i - s
        mbi = i - 2 * (S - 1) + s
        act_f, act_b = 0 <= mf < M, 0 <= mbi < M
        out_f = zeros
        if act_f:  # the forward of microbatch mf
            h_in = x_mb[mf] if s == 0 else recv_f
            stash[mf % depth] = h_in
            with torch.no_grad():
                out_f = run_stage(leaves, h_in).to(carry)
            if is_last:
                loss_sum += float(loss_fn(out_f, y_mb[mf]))
        gh = zeros
        if act_b:  # the backward of microbatch mbi, recomputed
            h_b = stash[mbi % depth].detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                out = run_stage(ps, h_b)
                if is_last:
                    # the last stage's cotangent: the loss VJP of the
                    # forward it ran this tick (mf == mbi there)
                    grads = torch.autograd.grad(
                        loss_fn(out, y_mb[mbi]) / M, ps + [h_b])
                else:
                    grads = torch.autograd.grad(
                        out, ps + [h_b], grad_outputs=recv_g.to(out.dtype))
            for a, g in zip(gacc, grads[:-1]):
                a.add_(g)
            gh = grads[-1].to(carry)
        recv_f = comm.ppermute(out_f, ax, 1)
        recv_g = comm.ppermute(gh, ax, -1)
    loss = comm.psum(loss_sum, ax) / M  # only the last stage's is non-zero
    gathered = [comm.all_gather(g, ax, 0) for g in gacc]
    return loss, tree_unflatten(local, gathered)
