"""Ring attention: sequence-parallel exact attention over a mesh axis (port
of ggmlsharp_tpu/parallel/ring_attention.py).

Rank d of the axis owns query rows [d·c, (d+1)·c) of the sequence (c =
S / n). Its K/V chunk goes round the ring with ``comm.ppermute``: at step s
it holds the chunk first owned by rank (d - s) mod n, folds a blockwise
online-softmax partial (m, l, acc) of its queries against it, and passes
the chunk on. Causality uses global positions. The result is exact
attention over the whole sequence; the ranks' rows are gathered at the end.

``set_sequence_mesh(mesh, seq_axis)`` installs the route the models take
under GGML_TPU_ATTN=ring (a prefill from an empty cache, S a multiple of
the axis size); ``set_sequence_mesh(None)`` clears it.
"""
from __future__ import annotations

import torch

from . import comm

NEG_INF = -1e30


def _block_partial(q, k, v, scale, qpos0, kpos0, causal):
    """(m, l, acc) of q [B,H,Sq,D] against one k/v block [B,H,Sk,D], f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        qi = qpos0 + torch.arange(s.shape[2], device=s.device)[:, None]
        ki = kpos0 + torch.arange(s.shape[3], device=s.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(torch.isfinite(m), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return m, l, acc


def _combine(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    w1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m),
                     torch.zeros_like(m))
    w2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m),
                     torch.zeros_like(m))
    return m, l1 * w1 + l2 * w2, a1 * w1 + a2 * w2


_SP_MESH = (None, "seq")


def set_sequence_mesh(mesh, seq_axis: str = "seq"):
    global _SP_MESH
    _SP_MESH = (mesh, seq_axis)


def sequence_mesh():
    return _SP_MESH


def ring_attention(q, k, v, mesh, seq_axis: str = "model",
                   causal: bool = True, scale: float | None = None):
    """Exact attention with the sequence sharded over ``seq_axis``.

    q, k, v: [B, H, S, D], the whole sequence on every rank (S a multiple
    of the axis size); each rank works on its own chunk. Returns
    [B, H, S, D] in q's dtype on every rank."""
    ax = comm.axis(mesh, seq_axis)
    n, me = ax.size, ax.rank
    S = q.shape[2]
    if S % n:
        raise ValueError(f"sequence {S} does not split over {n} ranks")
    c = S // n
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    qc = q[:, :, me * c:(me + 1) * c]
    kv = torch.stack([k[:, :, me * c:(me + 1) * c],
                      v[:, :, me * c:(me + 1) * c]])  # one message a hop
    B, H, _, D = q.shape
    m = torch.full((B, H, c, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, c, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, c, D), dtype=torch.float32, device=q.device)
    for step in range(n):
        src = (me - step) % n  # the rank whose chunk this is
        if step < n - 1:  # the next chunk travels while this one folds
            nxt = comm.ppermute_start(kv, ax, 1)
        bm, bl, bacc = _block_partial(qc, kv[0], kv[1], sc, me * c, src * c,
                                      causal)
        m, l, acc = _combine(m, l, acc, bm, bl, bacc)
        if step < n - 1:
            kv = nxt.wait()
    out = (acc / torch.where(l > 0, l, torch.ones_like(l))).to(q.dtype)
    return comm.all_gather(out, ax, 2)
