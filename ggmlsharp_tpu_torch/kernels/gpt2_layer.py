"""A whole GPT-2 block for one token in one launch: the CUDA kernel
``csrc/gpt2_layer.cu`` and its wrapper (port of
ggmlsharp_tpu/kernels/gpt2_layer.py::gpt2_layer_step).

ln1 -> qkv (+ bias) -> causal attention over the cache rows ``< npast`` plus
this token's fresh K/V -> proj (+ bias, + residual) -> ln2 -> GELU fc ->
cproj (+ bias, + residual), all in f32 with no activation quantization. The
block's K/V cache [T, E] is read only; the caller writes the returned
``k_new``/``v_new`` to row ``npast``. Row ``npast`` of the cache is stale and
never attended; rows ``>= T`` do not exist, so ``npast > T`` attends all T
rows and the fresh one.

Everything is in element order and the four weights are read in the block's
one Q8_0 copy: the JAX package's wire order, permuted planes and one-hot head
reduction exist for the TPU only.

The kernel is one persistent CTA an SM whose producer warp copies the CTA's
share of all four weights into shared memory (TMA bulk copies);
``smem_plan`` cuts the shares into pieces and places them there (a ring of
pieces where the shares do not fit at once; ``place``, which the fused GELU
MLP's one-row instance shares, ``csrc/shares.cuh``), and the wrapper hands
the plan to the launch. The CTAs exchange qkv, the attention output, x2 and h as
(value, launch generation) words in ``_sync.exchange_buffer``; the
generation and per-head counters live in ``_sync.sync_buffer`` (one each
for a (device, stream)).

The plain version is ``_layer_ref``. The wrapper runs it for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..dtypes import GType
from ..ops.attention import NEG_INF
from ..ops.basic import gelu, norm
from ..ops.matmul import mul_mat_q
from ..quant.formats import QTensor
from . import _build
from ._sync import MAX_HEADS, exchange_buffer, sync_buffer
from .config import use_kernel

_TILE_BYTES = 9 * 1024 * 1024
_CHUNKS = 8  # attention partials a head (csrc/gpt2_layer.cu CHUNKS)
_CONSUMER_WARPS = 16  # csrc/gpt2_layer.cu CW
_MAX_PIECES = 64  # csrc/shares.cuh MAX_PIECES
_MAX_E = 2560  # csrc/gpt2_layer.cu LNP * NC
_RING_PIECE = 32768  # the most qs bytes a piece of a ring
_PLANS: dict = {}  # (E, F, H, ctas, smem) -> (SmemPlan, its ctypes ints)


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclass(frozen=True)
class SmemPlan:
    """Where the kernel keeps what in its dynamic shared memory (byte
    offsets): the activation vector at 0, then ``red`` (the products'
    partial sums), ``att`` (attention and norm scratch, ln2's gain and
    bias), ``bar`` (a full
    and an empty mbarrier a piece) and ``ring``. ``pieces``: (weight, first
    row of the CTA's share, rows, byte offset in the ring, the piece whose
    release it waits for or -1, rows a unit and splits: ``unit_plan``),
    weights in phase order (c_attn, attn
    c_proj, c_fc, mlp c_proj); a piece holds its rows' qs, then their
    scales from the 16-byte bound below the first. ``rows``: the most rows
    of each weight a CTA owns. ``smem``: the bytes a CTA takes."""
    ctas: int
    rows: tuple
    red: int
    att: int
    bar: int
    ring: int
    smem: int
    first: tuple
    pieces: tuple

    @property
    def reuses(self) -> bool:
        return any(p[4] >= 0 for p in self.pieces)

    def ints(self) -> list:
        """The plan as the C entry takes it: n, red, att, bar, ring, smem,
        ctas, first[5], then seven ints a piece."""
        head = [len(self.pieces), self.red, self.att, self.bar, self.ring,
                self.smem, self.ctas, *self.first]
        return head + [v for p in self.pieces for v in p]


def unit_plan(rows: int, k: int, cw: int = _CONSUMER_WARPS) -> tuple:
    """(rows a unit, splits P) for a piece of ``rows`` rows of length k:
    the ``cw`` consumer warps take units of 1 or 2 rows and every P-th of the
    row's 256-element steps; the choice with the fewest rounds of the
    longest unit (a step of a row 1, a row's reduction 1/2, a unit 1)."""
    steps = -(-k // 256)
    best = None
    for rw in (2, 1):
        groups = -(-rows // rw)
        for p in range(1, min(steps, cw) + 1):
            rounds = -(-groups * p // cw)
            cost = rounds * (-(-steps // p) * rw + 0.5 * rw + 1.0)
            if best is None or cost < best[0] - 1e-9:
                best = (cost, rw, p)
    return best[1], best[2]


def piece_bytes(rows: int, k: int) -> int:
    """Shared-memory bytes of a piece of ``rows`` Q8_0 rows of length k: the
    qs, then the scales widened to 16-byte bounds (at most 16 bytes more
    than their 16-byte round-up)."""
    return rows * k + _up16(rows * k // 16) + 16


def smem_plan(E: int, F: int, H: int, ctas: int, smem: int) -> SmemPlan:
    """The kernel's shared-memory plan for a block of widths (E, F) with H
    heads on ``ctas`` CTAs of at most ``smem`` bytes of shared memory each
    (``place`` with the block's four weights, the activation vector and
    the attention and norm scratch)."""
    if E % 128 or F % 128 or E % H or (E // H) % 32 or E // H > 128 \
            or E > _MAX_E:
        raise ValueError(f"smem_plan: E {E}, F {F}, heads {H}")
    att = _up16((3 * _CONSUMER_WARPS + (_CONSUMER_WARPS + 3) * (E // H)
                 + 2 * E) * 4)
    return place(((3 * E, E), (E, E), (F, E), (E, F)), ctas, smem,
                 max(E, F) * 4, att)


def place(mats, ctas: int, smem: int, vec_bytes: int, att: int,
          cw: int = _CONSUMER_WARPS) -> SmemPlan:
    """The shared-memory plan of up to four Q8_0 weights ``mats`` ((N, K)
    each, in phase order) on ``ctas`` CTAs of at most ``smem`` bytes: the
    activation vector (``vec_bytes``) at 0, then the partial sums, the
    kernel's own scratch (``att`` bytes), the mbarriers and the ring (csrc/
    shares.cuh). Every CTA's share of every weight at once if it fits (one
    piece a weight, none waits); else pieces of at most _RING_PIECE qs bytes
    placed in a ring in phase order, a piece waiting for the release of the
    last earlier piece whose bytes it overwrites; ``cw`` consumer warps
    take each piece (unit_plan). ValueError where a CTA's share passes a
    consumer thread a row or a piece cannot fit."""
    rows = tuple(-(-n // ctas) for n, _ in mats)
    if max(rows) > 32 * cw:
        raise ValueError(f"smem_plan: {max(rows)} rows a CTA exceed a "
                         f"consumer thread a row")
    red = _up16(max(rows) * cw * 4)
    off_red = _up16(vec_bytes)
    off_att = off_red + red
    off_bar = off_att + att

    def cut(most_qs):
        out = []
        for w, (r_all, (_, k)) in enumerate(zip(rows, mats)):
            step = r_all if most_qs is None else max(1, most_qs // k)
            out += [(w, i, min(step, r_all - i)) for i in range(0, r_all, step)]
        return out

    whole = cut(None)
    ring = off_bar + 16 * len(whole)
    need = sum(piece_bytes(r, mats[w][1]) for w, _, r in whole)
    if ring + need <= smem:
        placed, pos = [], 0
        for w, i, r in whole:
            placed.append((w, i, r, pos, -1, *unit_plan(r, mats[w][1], cw)))
            pos += piece_bytes(r, mats[w][1])
        return _plan(ctas, rows, off_red, off_att, off_bar, ring, ring + pos,
                     placed)
    most = _RING_PIECE
    while True:
        pieces = cut(most)
        ring = off_bar + 16 * len(pieces)
        if len(pieces) <= _MAX_PIECES:
            break
        most *= 2
    room = smem - ring
    placed, live, pos = [], [], 0
    for j, (w, i, r) in enumerate(pieces):
        size = piece_bytes(r, mats[w][1])
        if size > room:
            raise ValueError(f"smem_plan: a piece of {size} bytes exceeds "
                             f"the {room} bytes left for the ring")
        if pos + size > room:
            pos = 0
        hit = [p for p in live if p[0] < pos + size and pos < p[1]]
        live = [p for p in live if p not in hit] + [(pos, pos + size, j)]
        placed.append((w, i, r, pos, max((p[2] for p in hit), default=-1),
                       *unit_plan(r, mats[w][1], cw)))
        pos += size
    end = max(p[3] + piece_bytes(p[2], mats[p[0]][1]) for p in placed)
    return _plan(ctas, rows, off_red, off_att, off_bar, ring, ring + end,
                 placed)


def _plan(ctas, rows, red, att, bar, ring, total, placed) -> SmemPlan:
    first = [0] * 5  # four weights' first pieces, then the piece count
    for w in range(4):
        first[w + 1] = first[w] + sum(1 for p in placed if p[0] == w)
    return SmemPlan(ctas, rows, red, att, bar, ring, total, tuple(first),
                    tuple(placed))


def device_smem(device) -> tuple:
    """(SMs, the shared memory a CTA may opt into) of ``device``: where the
    attribute is missing, an SM's shared memory less the 1 KB the runtime
    reserves for each CTA."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin", None) \
        or props.shared_memory_per_multiprocessor - 1024
    return props.multi_processor_count, smem


def _device_plan(E: int, F: int, H: int, device):
    """smem_plan for ``device`` (its SMs, and the shared memory a CTA may
    opt into), made once and kept with its ctypes copy."""
    sms, smem = device_smem(device)
    key = (E, F, H, sms, smem)
    got = _PLANS.get(key)
    if got is None:
        plan = smem_plan(E, F, H, sms, smem)
        ints = plan.ints()
        got = (plan, (ctypes.c_int * len(ints))(*ints))
        _PLANS[key] = got
    return got


def _pick_tile(n: int, k: int) -> int:
    for t in (512, 384, 256, 128):
        if n % t == 0 and 8 * k * t <= _TILE_BYTES:
            return t
    return 0


def gpt2_layer_fuse_supported(E: int, F: int) -> bool:
    """Whether an (E, F) block takes the whole-block route. This is the JAX
    package's gate (its kernel's tile and alignment limits), kept so that
    both packages take the same route on the same config; the CUDA kernel
    itself needs less (E and F multiples of 32)."""
    return (E % 128 == 0 and F % 128 == 0
            and all((_pick_tile(3 * E, E), _pick_tile(E, E),
                     _pick_tile(F, E), _pick_tile(E, F))))


def block_fusable(blk) -> bool:
    """A block of a parameter tree whose four weights are Q8_0 and whose
    widths pass gpt2_layer_fuse_supported."""
    ws = (blk["attn"]["c_attn_w"], blk["attn"]["c_proj_w"],
          blk["mlp"]["c_fc_w"], blk["mlp"]["c_proj_w"])
    if not all(isinstance(w, QTensor) and w.gtype == GType.Q8_0 for w in ws):
        return False
    return gpt2_layer_fuse_supported(ws[1].shape[0], ws[2].shape[0])


def _vectors(blk):
    """The block's four biases and two layer-norm pairs, in the kernel's
    argument order."""
    return (blk["attn"]["c_attn_b"], blk["attn"]["c_proj_b"],
            blk["mlp"]["c_fc_b"], blk["mlp"]["c_proj_b"],
            blk["ln_1"]["g"], blk["ln_1"]["b"],
            blk["ln_2"]["g"], blk["ln_2"]["b"])


def _layer_ref(blk, x, k_cache, v_cache, npast, n_head: int, ln_eps: float):
    """Plain version. x [1, E]; k_cache/v_cache [T, E]; npast an int tensor
    (no host read) -> (y, k_new, v_new), each f32 [1, E]."""
    f32 = torch.float32
    E = x.shape[-1]
    T = k_cache.shape[0]
    D = E // n_head
    attn, mlp = blk["attn"], blk["mlp"]

    def ln(v, p):
        return norm(v, ln_eps) * p["g"].to(f32) + p["b"].to(f32)

    def mm(w, v):
        return mul_mat_q(w, v, quantize_acts=False)

    x = x.to(f32).reshape(1, E)
    qkv = mm(attn["c_attn_w"], ln(x, blk["ln_1"])) + attn["c_attn_b"].to(f32)
    q, k_new, v_new = qkv.split(E, dim=-1)
    qh = q.reshape(n_head, D) * (1.0 / D ** 0.5)
    kh = k_cache.to(f32).reshape(T, n_head, D)
    vh = v_cache.to(f32).reshape(T, n_head, D)
    s = torch.einsum("hd,thd->ht", qh, kh)
    live = torch.arange(T, device=x.device) < npast.reshape(())
    s = torch.where(live[None, :], s, torch.full_like(s, NEG_INF))
    s_new = (qh * k_new.reshape(n_head, D)).sum(-1, keepdim=True)
    p = torch.softmax(torch.cat([s, s_new], dim=1), dim=-1)
    a = torch.einsum("ht,thd->hd", p[:, :T], vh) \
        + p[:, T:] * v_new.reshape(n_head, D)
    x2 = x + mm(attn["c_proj_w"], a.reshape(1, E)) + attn["c_proj_b"].to(f32)
    h = gelu(mm(mlp["c_fc_w"], ln(x2, blk["ln_2"])) + mlp["c_fc_b"].to(f32))
    y = x2 + mm(mlp["c_proj_w"], h) + mlp["c_proj_b"].to(f32)
    return y, k_new, v_new


def gpt2_layer_step(blk, x, k_cache, v_cache, npast, n_head: int,
                    ln_eps: float):
    """One decode step through one block. blk: the block's parameters
    (ln_1, attn, ln_2, mlp; Q8_0 weights); x f32 [1, E]; k_cache/v_cache
    [T, E], the cache's first T rows (bf16 or f32); npast: an int tensor on
    x's device. Returns (y, k_new, v_new), each f32 [1, E]."""
    if not use_kernel(x):
        return _layer_ref(blk, x, k_cache, v_cache, npast, n_head, ln_eps)
    attn, mlp = blk["attn"], blk["mlp"]
    ws = (attn["c_attn_w"], attn["c_proj_w"], mlp["c_fc_w"], mlp["c_proj_w"])
    if not all(isinstance(w, QTensor) and w.gtype == GType.Q8_0 for w in ws):
        raise TypeError("gpt2_layer_step: the four weights must be Q8_0")
    E = x.shape[-1]
    F = ws[2].shape[0]
    T = k_cache.shape[0]
    if [w.shape for w in ws] != [(3 * E, E), (E, E), (F, E), (E, F)]:
        raise ValueError(f"gpt2_layer_step: weight shapes "
                         f"{[w.shape for w in ws]} for E {E}")
    if E % 128 or F % 128 or E % n_head or (E // n_head) % 32 \
            or E // n_head > 128 or n_head > MAX_HEADS:
        raise ValueError(f"gpt2_layer_step: E {E}, heads {n_head}, F {F}")
    if tuple(x.shape) != (1, E) or x.dtype != torch.float32 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"gpt2_layer_step: x {tuple(x.shape)} {x.dtype}")
    if k_cache.shape != (T, E) or v_cache.shape != (T, E) \
            or k_cache.dtype != v_cache.dtype \
            or k_cache.dtype not in (torch.bfloat16, torch.float32) \
            or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("gpt2_layer_step: cache rows must be contiguous "
                         "[T, E] bf16 or f32")
    vecs = _vectors(blk)
    want = [(3 * E,), (E,), (F,), (E,)] + [(E,)] * 4
    if [tuple(v.shape) for v in vecs] != want:
        raise ValueError("gpt2_layer_step: bias or layer-norm shapes")
    if len({v.dtype for v in vecs}) != 1 \
            or vecs[0].dtype not in (torch.float32, torch.bfloat16):
        vecs = tuple(v.to(torch.float32) for v in vecs)
    vecs = tuple(v if v.is_contiguous() else v.contiguous() for v in vecs)
    np32 = npast if npast.dtype == torch.int32 and npast.dim() == 1 \
        else npast.to(torch.int32).reshape(1)
    if np32.numel() != 1:
        raise ValueError("gpt2_layer_step: npast must hold one integer")
    planes = [w[p] for w in ws for p in ("qs", "d")]
    if any(t.device != x.device
           for t in (k_cache, v_cache, np32, *vecs, *planes)):
        raise ValueError("gpt2_layer_step: inputs must be on one CUDA device")
    if not all(p.is_contiguous() and p.data_ptr() % 16 == 0
               for p in planes):
        raise ValueError("gpt2_layer_step: weights must be contiguous and "
                         "16-byte aligned")
    # one buffer: y [E], qkv [3E] (k_new, v_new are its thirds), then the
    # kernel's attention partials
    n_part = n_head * _CHUNKS * (E // n_head + 2)
    buf = torch.empty(4 * E + n_part, dtype=torch.float32, device=x.device)
    base = buf.data_ptr()
    y, qkv, part = base, base + 4 * E, base + 16 * E
    (qa, da), (qp, dp), (qf, df), (qc, dc) = (
        (w["qs"].data_ptr(), w["d"].data_ptr()) for w in ws)
    ba, bp, bf, bc, g1, b1, g2, b2 = (v.data_ptr() for v in vecs)
    fn = _build.entry("gpt2_layer")
    _, plan = _device_plan(E, F, n_head, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        sync = sync_buffer(x.device, stream)
        xch = exchange_buffer(x.device, stream, 5 * E + F)
        rc = fn(x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                np32.data_ptr(), qa, da, ba, qp, dp, bp, qf, df, bf,
                qc, dc, bc, g1, b1, g2, b2, y, qkv, part, xch.data_ptr(),
                sync.data_ptr(), plan, E, n_head, F, T, float(ln_eps),
                int(k_cache.dtype == torch.bfloat16),
                int(vecs[0].dtype == torch.bfloat16), stream)
    _build.check("gpt2_layer", rc)
    return (buf[:E].reshape(1, E), buf[2 * E:3 * E].reshape(1, E),
            buf[3 * E:4 * E].reshape(1, E))
