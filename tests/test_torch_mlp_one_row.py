"""The one-row instances of the two fused MLPs on the CPU (the CUDA kernels
run only on the card; ``chip_smoke.py`` holds them against their plain
versions there):

  * kernel 9 (``csrc/mlp_fused_silu_q4.cu``) and kernel 8
    (``csrc/mlp_fused_q8.cu``): what one row hands the b = 1 entry (its
    operands, the scratch, the sync buffer and the exchange buffer kept for
    the stream, kernel 8's shared-memory plan), with a stand-in for the C
    entry; two rows reach the multi-row entry with its arguments unchanged;
  * a plane or a width the kernel's loads cannot take is refused with a
    ValueError before any launch;
  * kernel 8's shared-memory plan (``mlp_fused.mlp_smem_plan``) at GPT-2
    124M, 355M, 774M and at E 2048 (whose shares take a ring of pieces) on
    132 CTAs of 232,448 bytes: 16-byte offsets and copies, every row once,
    the kernel's constants; kernel 9's shared memory at Llama-7B and 13B.
"""
import contextlib
import os
import re

import pytest
import torch

from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.kernels import _build, _sync
from ggmlsharp_tpu_torch.kernels import matmul_q as mq
from ggmlsharp_tpu_torch.kernels import mlp_fused as mf
from ggmlsharp_tpu_torch.kernels.gpt2_layer import piece_bytes
from ggmlsharp_tpu_torch.quant.formats import QTensor

CTAS, SMEM = 132, 232448


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = property(lambda self: True)


@pytest.fixture
def entries(monkeypatch):
    """Every C entry replaced by a recorder that returns 0 (success); an
    H100's SM count and shared memory, a stream stand-in, fresh counters
    and fresh sync and exchange buffers. Yields the (name, args) list."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class _Stream:
        cuda_stream = 7

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(mf, "device_sms", lambda device: CTAS)
    monkeypatch.setattr(mf, "device_smem", lambda device: (CTAS, SMEM))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_sync, "_SYNC", {})
    monkeypatch.setattr(_sync, "_XCH", {})
    monkeypatch.setattr(mf, "_PLANS", {})
    return calls


def _silu(E, F, seed=0):
    gen = torch.Generator().manual_seed(seed)
    w1 = quantize(torch.randn((2 * F, E), generator=gen) * 0.1, GType.Q4_0)
    w2 = quantize(torch.randn((E, F), generator=gen) * 0.1, GType.Q4_0)
    return w1, w2, gen


def _gelu(E, seed=0, n2=None, bias=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    n2 = E if n2 is None else n2
    w1 = quantize(torch.randn((4 * E, E), generator=gen) * 0.1, GType.Q8_0)
    w2 = quantize(torch.randn((n2, 4 * E), generator=gen) * 0.1, GType.Q8_0)
    b1 = (torch.randn(4 * E, generator=gen) * 0.1).to(bias)
    b2 = (torch.randn(n2, generator=gen) * 0.1).to(bias)
    return w1, b1, w2, b2, gen


def _ptrs(w):
    return w["qs"].data_ptr(), w["d"].data_ptr()


# --- kernel 9 -------------------------------------------------------------

@pytest.mark.parametrize("E,F", [(256, 512), (384, 640)])
def test_silu_one_row_entry(entries, E, F):
    """One row: x, the weights, a gated-product scratch of F floats, y,
    (1, E, F), then the stream's sync buffer (its grid barrier and chunk
    counters), then the stream; one count of ``mlp_fused_silu_q4``."""
    w1, w2, gen = _silu(E, F)
    x = torch.randn((1, E), generator=gen).as_subclass(_OnCard)
    y = mf.mlp_fused_silu_q4(x, w1, w2)
    (name, args), = entries
    assert name == "mlp_fused_silu_q4" and tuple(y.shape) == (1, E)
    assert args[0] == x.data_ptr() and args[1:5] == (*_ptrs(w1), *_ptrs(w2))
    assert args[6] == y.data_ptr() and args[7:10] == (1, E, F)
    sync = _sync.sync_buffer(x.device, 7)
    assert args[10:12] == (sync.data_ptr(), 7) and len(args) == 12
    assert sync.dtype == torch.int32 and not sync.any()
    assert args[5] not in (0, None, x.data_ptr(), y.data_ptr())
    assert _build.LAUNCHES["mlp_fused_silu_q4"] == 1
    assert sum(_build.LAUNCHES.values()) == 1


def test_silu_buffers_are_kept_for_the_stream(entries):
    """Two launches on one stream take the same sync buffer (each launch
    leaves its barrier word and counters as it found them)."""
    w1, w2, gen = _silu(256, 512)
    x = torch.randn((1, 256), generator=gen).as_subclass(_OnCard)
    mf.mlp_fused_silu_q4(x, w1, w2)
    mf.mlp_fused_silu_q4(x, w1, w2)
    (_, a1), (_, a2) = entries
    assert a1[10] == a2[10] and a1[5] != 0
    assert _build.LAUNCHES["mlp_fused_silu_q4"] == 2


@pytest.mark.parametrize("quantize_acts", [False, True])
def test_silu_two_rows_take_the_multi_row_entry_unchanged(entries,
                                                          quantize_acts):
    """Two rows: mlp_fused_silu_q4_mma's arguments as before (activations,
    weights, y, scratch, B, E, F, the two products' splits, stream)."""
    E, F = 256, 512
    w1, w2, gen = _silu(E, F)
    x = torch.randn((2, E), generator=gen).as_subclass(_OnCard)
    mf.flash_ff_silu_q4(w1, w2, x, quantize_acts=quantize_acts)
    (name, args), = entries
    assert name == "mlp_fused_silu_q4_mma" and len(args) == 15
    assert args[3:7] == (*_ptrs(w1), *_ptrs(w2)) and args[8] is not None
    assert args[9:15] == (2, E, F, mq.mma_splits(2 * F, E, CTAS),
                          mq.mma_splits(E, F, CTAS), 7)
    assert (args[0] is None) == quantize_acts


def _offset_plane(w: QTensor, plane: str, dtype) -> QTensor:
    """w with one plane moved to an address 2 bytes past a 16-byte bound
    (same values)."""
    t = w[plane]
    buf = torch.empty(t.numel() * t.element_size() + 64, dtype=torch.uint8)
    off = (-buf.data_ptr()) % 16 + 2
    view = buf[off:off + t.numel() * t.element_size()].view(dtype)
    view.copy_(t.reshape(-1).view(dtype))
    planes = dict(w.planes)
    planes[plane] = view.reshape(t.shape).as_subclass(_OnCard)
    return QTensor(w.gtype, w.shape, planes)


def test_silu_refuses_misaligned_quants_before_a_launch(entries):
    w1, w2, gen = _silu(256, 512)
    x = torch.randn((1, 256), generator=gen).as_subclass(_OnCard)
    for bad in ((_offset_plane(w1, "qs", torch.uint8), w2),
                (w1, _offset_plane(w2, "qs", torch.uint8))):
        with pytest.raises(ValueError):
            mf.mlp_fused_silu_q4(x, *bad)
    xm = torch.empty(257 + 4)[1:257].reshape(1, 256).as_subclass(_OnCard)
    with pytest.raises(ValueError):
        mf.mlp_fused_silu_q4(xm, w1, w2)
    assert not entries


def test_silu_refuses_a_width_past_a_ctas_shared_memory(entries):
    """E 128, F 52224: the copy of the gated product alone (1,632 blocks of
    144 bytes) exceeds a CTA's 232,448 bytes: refused before a launch."""
    E, F = 128, 52224
    assert mf.silu_one_row_smem(E, F) > SMEM
    w1 = QTensor(GType.Q4_0, (2 * F, E), {
        "qs": torch.zeros((2 * F, E // 2), dtype=torch.uint8),
        "d": torch.zeros((2 * F, E // 32), dtype=torch.float16)})
    w2 = QTensor(GType.Q4_0, (E, F), {
        "qs": torch.zeros((E, F // 2), dtype=torch.uint8),
        "d": torch.zeros((E, F // 32), dtype=torch.float16)})
    x = torch.zeros((1, E)).as_subclass(_OnCard)
    assert mf.mlp_silu_fuse_supported(w1, w2, 1)
    with pytest.raises(ValueError, match="shared memory"):
        mf.mlp_fused_silu_q4(x, w1, w2)
    assert not entries


@pytest.mark.parametrize("E,F", [(4096, 11008), (5120, 13824)])
def test_silu_shared_memory_fits_llama(E, F):
    """Llama-7B and 13B fit two CTAs an SM (the grid's 32 warps an SM), and
    the chunk counters fit the sync buffer's counter words."""
    assert 2 * mf.silu_one_row_smem(E, F) <= 228 * 1024
    assert 2 * -(-F // 1024) <= _sync.MAX_HEADS


def test_silu_smem_constants_are_the_kernels():
    with open(os.path.join(_build.CSRC, "dq_vec.cuh")) as f:
        vec = f.read()
    assert int(re.search(r"constexpr int XU = (\d+);", vec)[1]) * 4 == 144
    assert int(re.search(r"constexpr int SMEM_MAX = (\d+);", vec)[1]) \
        == mf._SMEM_MAX
    with open(os.path.join(_build.CSRC, "mlp_fused_silu_q4.cu")) as f:
        src = f.read()
    assert "smem_bytes(m.E, m.F)" in src


# --- kernel 8 -------------------------------------------------------------

@pytest.mark.parametrize("E", [256, 384])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [torch.float32, torch.bfloat16])
def test_gelu_one_row_entry(entries, E, mode, bias):
    """One row: x, the weights and biases, the stream's exchange buffer of
    N1 words (h), y, (1, K1, N1, N2, bias_bf16, rx), the stream's sync
    buffer, the plan mlp_smem_plan makes for the card (one CTA an SM) and
    its consumer warps, then the stream; one count of ``mlp_fused_q8``."""
    w1, b1, w2, b2, gen = _gelu(E, bias=bias)
    x = torch.randn((1, E), generator=gen).as_subclass(_OnCard)
    y = mf.mlp_fused_q8(x, w1, b1, w2, b2, mode=mode)
    (name, args), = entries
    assert name == "mlp_fused_q8" and tuple(y.shape) == (1, E)
    assert args[0] == x.data_ptr()
    assert args[1:7] == (*_ptrs(w1), b1.data_ptr(), *_ptrs(w2),
                         b2.data_ptr())
    xh = _sync.exchange_buffer(x.device, 7, 4 * E)
    assert args[7] == xh.data_ptr() and args[8] == y.data_ptr()
    assert args[9:15] == (1, E, 4 * E, E, int(bias == torch.bfloat16),
                          int(mode == "bf16"))
    assert args[15] == _sync.sync_buffer(x.device, 7).data_ptr()
    want = mf.mlp_smem_plan(E, 4 * E, E, CTAS, SMEM).ints()
    assert list(args[16]) == want
    assert args[17:19] == (mf.consumer_warps(4 * E, CTAS), 7)
    assert _build.LAUNCHES["mlp_fused_q8"] == 1
    assert sum(_build.LAUNCHES.values()) == 1


def test_gelu_one_row_shares_the_stream_buffers_with_kernel_11(entries):
    """Kernel 8's sync buffer is the one kernel 11 (gpt2_layer) takes on
    the same stream: their launches take turns on word 1, the tag."""
    w1, b1, w2, b2, gen = _gelu(256)
    x = torch.randn((1, 256), generator=gen).as_subclass(_OnCard)
    mf.mlp_fused_q8(x, w1, b1, w2, b2)
    (_, args), = entries
    assert args[15] == _sync.sync_buffer(x.device, 7).data_ptr()
    assert len(_sync._SYNC) == 1


@pytest.mark.parametrize("quantize_acts", [False, True])
def test_gelu_two_rows_take_the_multi_row_entry_unchanged(entries,
                                                          quantize_acts):
    E = 256
    w1, b1, w2, b2, gen = _gelu(E)
    x = torch.randn((2, E), generator=gen).as_subclass(_OnCard)
    mf.flash_ff_q8(w1, b1, w2, b2, x, quantize_acts=quantize_acts,
                   mode="f32")
    (name, args), = entries
    assert name == "mlp_fused_q8_mma" and len(args) == 20
    assert args[3:9] == (*_ptrs(w1), b1.data_ptr(), *_ptrs(w2),
                         b2.data_ptr())
    assert args[11:20] == (2, E, 4 * E, E, 0,
                           mq.q8_mma_splits(4 * E, E, CTAS),
                           mq.q8_mma_splits(E, 4 * E, CTAS), 0, 7)
    assert not _sync._XCH  # no exchange buffer: h is the launch's scratch


def test_gelu_refuses_misaligned_planes_before_a_launch(entries):
    w1, b1, w2, b2, gen = _gelu(256)
    x = torch.randn((1, 256), generator=gen).as_subclass(_OnCard)
    for bad in ((_offset_plane(w1, "qs", torch.int8), w2),
                (w1, _offset_plane(w2, "qs", torch.int8)),
                (_offset_plane(w1, "d", torch.float16), w2),
                (w1, _offset_plane(w2, "d", torch.float16))):
        with pytest.raises(ValueError):
            mf.mlp_fused_q8(x, bad[0], b1, bad[1], b2)
    assert not entries


def test_gelu_refuses_a_scale_plane_it_cannot_copy(entries):
    """W2 [3, 128]: its scale plane is 24 bytes, no multiple of 16, so a
    share's 16-byte copy could pass its end: refused before a launch."""
    w1, b1, w2, b2, gen = _gelu(32, n2=3)
    x = torch.randn((1, 32), generator=gen).as_subclass(_OnCard)
    assert mf.mlp_fuse_supported(w1, w2, 1)
    with pytest.raises(ValueError, match="mlp_smem_plan"):
        mf.mlp_fused_q8(x, w1, b1, w2, b2)
    assert not entries


# --- kernel 8's shared-memory plan ------------------------------------------

WIDTHS = {"124M": 768, "355M": 1024, "774M": 1280, "E2048": 2048}


def _mats(E):
    return ((4 * E, E), (E, 4 * E))


def _share(n, c, g=CTAS):
    return n * c // g, n * (c + 1) // g


@pytest.fixture(params=sorted(WIDTHS))
def plan(request):
    E = WIDTHS[request.param]
    return request.param, E, mf.mlp_smem_plan(E, 4 * E, E, CTAS, SMEM)


def test_plan_offsets_and_copies_are_16_byte_multiples(plan):
    _, E, p = plan
    cw = mf.consumer_warps(4 * E, CTAS)
    assert p.smem <= SMEM and p.ctas == CTAS
    for off in (p.red, p.att, p.bar, p.ring):
        assert off % 16 == 0
    assert p.red >= 4 * E * 4  # the activation vector holds x, then h
    assert p.att - p.red >= max(p.rows) * cw * 4  # a partial a row and warp
    assert p.bar - p.att >= mf._PLAN_BYTES  # the plan's own copy
    assert p.ring - p.bar >= 16 * len(p.pieces)
    for w, i0, rows, off, _, _, _ in p.pieces:
        n, k = _mats(E)[w]
        assert off % 16 == 0 and (rows * k) % 16 == 0
        assert p.ring + off + piece_bytes(rows, k) <= p.smem
        assert n * k // 16 % 16 == 0  # a share's widened scales stay inside
        for c in range(CTAS):
            lo, hi = _share(n, c)
            r = max(0, min(rows, hi - lo - i0))
            if r:
                start = (lo + i0) * (k // 16)
                d0, d1 = start // 16 * 16, -(-(start + r * k // 16) // 16) * 16
                assert rows * k + (d1 - d0) <= piece_bytes(rows, k)


def test_plan_covers_every_row_once(plan):
    _, E, p = plan
    assert p.first[2] == p.first[3] == p.first[4] == len(p.pieces)
    for w, (n, _) in enumerate(_mats(E)):
        mine = [q for q in p.pieces if q[0] == w]
        assert p.pieces[p.first[w]:p.first[w + 1]] == tuple(mine)
        assert [i for _, i0, r, *_ in mine for i in range(i0, i0 + r)] \
            == list(range(p.rows[w]))
        owned = []
        for c in range(CTAS):
            lo, hi = _share(n, c)
            assert 1 <= hi - lo <= p.rows[w]
            owned += range(lo, hi)
        assert owned == list(range(n))


def test_plan_fits_at_once_up_to_774m_and_e2048_takes_the_ring(plan):
    name, E, p = plan
    if name == "E2048":
        assert p.reuses
        span = [(q[3], q[3] + piece_bytes(q[2], _mats(E)[q[0]][1]))
                for q in p.pieces]
        for j, q in enumerate(p.pieces):
            assert q[4] < j
            for i in range(j):
                if span[i][0] < span[j][1] and span[j][0] < span[i][1]:
                    assert q[4] >= i
    else:
        assert not p.reuses and len(p.pieces) == 2


def test_plan_units_are_unit_plans_for_its_warps(plan):
    """Every piece's (rows a unit, splits) is unit_plan's for the plan's
    consumer warps: 12 up to 355M (at most 32 rows of W1 a CTA), 20 at
    774M and E 2048."""
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import unit_plan

    name, E, p = plan
    cw = mf.consumer_warps(4 * E, CTAS)
    assert cw == (12 if name in ("124M", "355M") else 20)
    for w, _, rows, _, _, rw, splits in p.pieces:
        assert (rw, splits) == unit_plan(rows, _mats(E)[w][1], cw)
        assert 1 <= splits <= cw


def test_plan_refuses_a_width_no_ring_fits():
    with pytest.raises(ValueError):
        mf.mlp_smem_plan(16384, 65536, 16384, CTAS, SMEM)


def test_plan_constants_are_the_kernels():
    from ggmlsharp_tpu_torch.kernels import gpt2_layer

    src = ""
    for name in ("mlp_fused_q8.cu", "shares.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            src += f.read()
    few, many = re.search(r"constexpr int CW_FEW = (\d+), CW_MANY = (\d+);",
                          src).groups()
    assert (int(few), int(many)) == mf._CONSUMER_WARPS
    max_pieces = int(re.search(r"constexpr int MAX_PIECES = (\d+);", src)[1])
    assert max_pieces == gpt2_layer._MAX_PIECES
    assert "H_LEN = H_FIRST + 5" in src and "PIECE_INTS = 7;" in src
    assert "H_FIRST, H_LEN" in src  # H_FIRST 7: a header of 12 ints
    assert mf._PLAN_BYTES == 4 * (12 + 7 * max_pieces)  # sizeof(Plan)
    p = mf.mlp_smem_plan(768, 3072, 768, CTAS, SMEM)
    ints = p.ints()
    assert ints[:7] == [len(p.pieces), p.red, p.att, p.bar, p.ring, p.smem,
                        CTAS]
    assert len(ints) == 12 + 7 * len(p.pieces)
