"""The wrappers of the dequant-matmuls and of the fused SwiGLU MLP at
several activation rows: the rows that take the multi-row instance of
``csrc/matmul_q4_0.cu``, ``csrc/matmul_q8_0.cu``, ``csrc/matmul_q.cu`` and
``csrc/mlp_fused_silu_q4.cu`` (``csrc/dq_mma.cuh``: from
``kernels.matmul_q.MMA_MIN_ROWS`` rows on). Their plain versions are held
against the TPU kernels in ``test_torch_matmul_formats.py`` (3-16 rows),
``test_torch_gpt2.py`` (Q8_0, 1-64 rows) and ``test_torch_llama_fused.py``
(the MLP, 1-64 rows).

  * The route a wrapper takes at each b, what it hands the multi-row entry
    (the K splits, the scratch for them) and the counters it bumps, with a
    stand-in for the C entry: the CUDA kernel itself runs only on the card
    (``chip_smoke.py`` holds it against the plain version there).
  * ``mma_splits`` and Q8_0's ``q8_mma_splits`` as functions of (N, K, SM
    count) alone.
"""
import contextlib
import inspect

import pytest
import torch

from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.kernels import _build
from ggmlsharp_tpu_torch.kernels import matmul_q as mq
from ggmlsharp_tpu_torch.kernels import mlp_fused as mf
from ggmlsharp_tpu_torch.ops import quantize_activations
from ggmlsharp_tpu_torch.quant.quantize import dequantize


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = property(lambda self: True)


@pytest.fixture
def fake_entries(monkeypatch):
    """Every C entry replaced by a recorder that returns 0 (success), the
    card's SM count fixed at the H100's, a stream stand-in, and fresh
    launch counters; yields the list of (entry name, arguments)."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(mq, "device_sms", lambda device: mq.H100_SMS)
    monkeypatch.setattr(mf, "device_sms", lambda device: mq.H100_SMS)
    monkeypatch.setattr(mf, "device_smem",
                        lambda device: (mq.H100_SMS, 232448))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_build, "GEOMETRY_LAUNCHES", {})
    return calls


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q5_0",
                                 "Q5_1", "Q4_K", "Q6_K"])
@pytest.mark.parametrize("rows", [1, 2, 5, 8, 16, 128])
def test_route_by_rows(fake_entries, fmt, rows):
    """One row takes the b = 1 instance at its geometry, MMA_MIN_ROWS and
    more the multi-row entry, with the splits mma_splits gives (N, K, SMs)
    and a scratch, and its own counter; GEOMETRY_LAUNCHES records the b = 1
    launch with its pair, the multi-row one with none."""
    n, k = 4096, 512
    w = quantize(torch.randn((n, k), generator=torch.Generator()
                             .manual_seed(rows)) * 0.1, GType[fmt])
    x = torch.randn((rows, k)).as_subclass(_OnCard)
    if fmt == "Q4_0":
        y = mq.q4_0_matmul(x, w["qs"], w["d"])
        kern = "matmul_q4_0"
    else:
        y = mq.q_matmul(x, w)
        kern = "matmul_q"
    assert tuple(y.shape) == (rows, n)
    (name, args), = fake_entries
    mma = rows >= mq.MMA_MIN_ROWS
    assert name == (f"{kern}_mma" if mma else kern)
    assert _build.LAUNCHES[name] == 1
    assert sum(_build.LAUNCHES.values()) == 1
    geom = mq.geometry(kern, n, k, GType[fmt], rows) if not mma \
        else (None, None)
    assert _build.GEOMETRY_LAUNCHES == {(name, n, k, *geom, rows): 1}
    if mma:
        # ..., y, scratch, B, N, K, splits, rx, stream
        scratch, (b_, n_, k_, splits) = args[-7], args[-6:-2]
        assert (b_, n_, k_) == (rows, n, k)
        assert splits == mq.mma_splits(n, k, mq.H100_SMS) == 2
        assert scratch is not None
    else:
        assert args[-4:-2] == geom  # warps, rows a warp
    assert args[-2] == 0  # rx: the wrappers' default mm_dot "f32"


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_K"])
def test_multi_row_ignores_a_compiled_geometry(fake_entries, fmt):
    """An explicit pair reaches no multi-row launch: a compiled one changes
    nothing the entry is handed, one never compiled still raises."""
    from ggmlsharp_tpu_torch.kernels import tune

    n, k = 256, 512
    w = quantize(torch.randn((n, k), generator=torch.Generator()
                             .manual_seed(3)) * 0.1, GType[fmt])
    x = torch.randn((5, k)).as_subclass(_OnCard)
    call = ((lambda g: mq.q4_0_matmul(x, w["qs"], w["d"], g))
            if fmt == "Q4_0" else (lambda g: mq.q_matmul(x, w, g)))
    for g in (None, *tune.GEOMETRIES):
        call(g)
    names = {name for name, _ in fake_entries}
    args = {args[-6:-2] for _, args in fake_entries}  # B, N, K, splits
    assert len(names) == 1 and names.pop().endswith("_mma")
    assert args == {(5, n, k, mq.mma_splits(n, k, mq.H100_SMS))}
    with pytest.raises(ValueError):
        call((3, 3))


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q5_0",
                                 "Q5_1", "Q4_K", "Q6_K"])
@pytest.mark.parametrize("rows", [1, 5])
def test_q8_activations_route(fake_entries, monkeypatch, fmt, rows):
    """With the Q8 round trip, several rows hand the multi-row entry the
    int8 values and their block scales as quantized (no f32 x), which
    reproduce the rounded activations exactly; one row keeps the rounded x
    on the b = 1 instance."""
    seen = []
    real = mq._launch_mma
    monkeypatch.setattr(mq, "_launch_mma",
                        lambda *a: seen.append(a) or real(*a))
    gen = torch.Generator().manual_seed(rows)
    w = quantize(torch.randn((256, 512), generator=gen) * 0.1, GType[fmt])
    x = torch.randn((rows, 512), generator=gen)
    y = mq.mul_mat_q_fused(w, x.as_subclass(_OnCard))
    assert tuple(y.shape) == (rows, 256)
    (name, args), = fake_entries
    kern = "matmul_q4_0" if fmt == "Q4_0" else "matmul_q"
    if rows == 1:
        assert name == kern and not seen
        return
    assert name == f"{kern}_mma"
    (_, _, acts, _, n), = seen
    xq, xd, kind = acts
    aq = quantize_activations(x, GType[fmt])
    cols = 512 // xd.shape[-1]
    assert xq.dtype == torch.int8 and tuple(xq.shape) == (rows, 512)
    assert (kind, cols) == mq._Q8_SCALES[(aq.gtype, xd.dtype)]
    got = (xq.float().reshape(rows, -1, cols)
           * xd.float()[..., None]).reshape(rows, 512)
    assert torch.equal(got, dequantize(aq))
    x_ptr = args[1] if fmt != "Q4_0" else args[0]
    assert x_ptr is None  # no f32 activations


def test_scratch_bytes():
    """The activations' bf16 planes (three for f32 x, one for Q8; rounded
    up to 16 bytes), their 16-column sums (a row padded to 4 floats), for
    Q8 their 32-column scales (likewise), and the partial sums only when K
    is split."""
    assert mq._mma_scratch_bytes(5, 4096, 512, 1) == 3 * 5 * 512 * 2 + 5 * 32 * 4
    assert mq._mma_scratch_bytes(5, 4096, 512, 2) == \
        3 * 5 * 512 * 2 + 5 * 32 * 4 + 2 * 5 * 4096 * 4
    # K = 96: 6 sums a row, padded to 8; planes 1728 bytes, a multiple of 16
    assert mq._mma_scratch_bytes(3, 8, 96, 1) == 1728 + 3 * 8 * 4
    assert mq._mma_scratch_bytes(1, 8, 32, 1) == 192 + 16
    assert mq._mma_scratch_bytes(5, 4096, 512, 2, 1) == \
        5 * 512 * 2 + 5 * 32 * 4 + 5 * 16 * 4 + 2 * 5 * 4096 * 4
    assert mq._mma_scratch_bytes(1, 8, 96, 1, 1) == 192 + 32 + 16


def test_min_rows_is_two():
    """Set by measurement (PERF.md §6): the multi-row instance wins
    from two rows on."""
    assert mq.MMA_MIN_ROWS == 2


@pytest.mark.parametrize("n,k,sms,want", [
    (4096, 4096, 132, 8),     # wo: 32 row tiles; at most 8 splits
    (4096, 11008, 132, 8),    # w_down: 43 chunks
    (4099, 11008, 132, 8),    # ragged: 33 tiles
    (12288, 4096, 132, 4),    # wqkv: 96 tiles want 5; 16 chunks go 4 x 4
    (12288, 11008, 132, 5),   # 43 chunks: 5 splits of at most 9
    (22016, 4096, 132, 3),    # w_gate_up: 172 tiles
    (32000, 4096, 132, 2),    # the LM head: 250 tiles
    (4096, 256, 132, 1),      # one chunk: never more splits than chunks
    (4096, 512, 132, 2),
    (128, 11008, 132, 8),     # one tile
    (4096, 4096, 33, 4),      # a quarter of the SMs, a quarter of the CTAs
    (4096, 4096, 1, 1),       # more tiles than CTAs wanted: one split
])
def test_mma_splits(n, k, sms, want):
    assert mq.mma_splits(n, k, sms) == want


def test_mma_splits_reads_no_rows_and_refuses_nonsense():
    assert list(inspect.signature(mq.mma_splits).parameters) == [
        "n", "k", "sms"]
    for bad in ((0, 4096, 132), (4096, 0, 132), (4096, 4096, 0)):
        with pytest.raises(ValueError):
            mq.mma_splits(*bad)


# --- Q8_0 (kernel 4): f32 x on three bf16 planes, Q8_0 activations on the
# int8 tensor cores; 64-row tiles, q8_mma_splits ----------------------------

def _q8_weight(n, k, seed):
    return quantize(torch.randn((n, k), generator=torch.Generator()
                                .manual_seed(seed)) * 0.1, GType.Q8_0)


@pytest.mark.parametrize("rows", [1, 2, 5, 16, 64, 128])
def test_q8_0_route_by_rows(fake_entries, rows):
    """f32 x: one row takes the b = 1 instance at its geometry, more rows
    the multi-row entry with x (no Q8 values), its 64-row tile and
    q8_mma_splits' splits, reduced in clusters (no scratch); each its own
    counter."""
    n, k = 2304, 768
    w = _q8_weight(n, k, rows)
    x = torch.randn((rows, k)).as_subclass(_OnCard)
    y = mq.q8_0_matmul(x, w["qs"], w["d"])
    assert tuple(y.shape) == (rows, n)
    (name, args), = fake_entries
    mma = rows >= mq.MMA_MIN_ROWS
    assert name == ("matmul_q8_0_mma" if mma else "matmul_q8_0")
    assert _build.LAUNCHES[name] == 1 and sum(_build.LAUNCHES.values()) == 1
    geom = (None, None) if mma else mq.geometry("matmul_q8_0", n, k,
                                                GType.Q8_0, rows)
    assert _build.GEOMETRY_LAUNCHES == {(name, n, k, *geom, rows): 1}
    if not mma:
        assert args[-4:-2] == geom and args[-2] == 0  # warps, rpw, rx
        return
    # x, xq, xd, kind, qs, d, y, scratch, B, N, K, rows, splits, rx, stream
    assert args[0] == x.data_ptr() and args[1] is None and args[2] is None
    assert args[4:6] == (w["qs"].data_ptr(), w["d"].data_ptr())
    assert args[7] is None
    assert args[8:13] == (rows, n, k, mq.MMA_ROWS_Q8,
                          mq.q8_mma_splits(n, k, mq.H100_SMS))
    assert args[12] == 3 and args[13] == 0


@pytest.mark.parametrize("n,k", [(256, 256), (768, 768)])
@pytest.mark.parametrize("rows", [1, 2, 5, 16, 64, 128])
def test_q8_0_q8_activations_route(fake_entries, monkeypatch, n, k, rows):
    """With the Q8_0 round trip, two or more rows hand the multi-row entry
    the int8 values and f16 block scales as quantized (kind 0, no f32 x),
    which reproduce the rounded activations exactly; the int8 route takes
    the 64-row tile and reduces its splits in clusters (no scratch)."""
    seen = []
    real = mq._launch_mma
    monkeypatch.setattr(mq, "_launch_mma",
                        lambda *a: seen.append(a) or real(*a))
    gen = torch.Generator().manual_seed(rows)
    w = quantize(torch.randn((n, k), generator=gen) * 0.1, GType.Q8_0)
    x = torch.randn((rows, k), generator=gen)
    y = mq.mul_mat_q_fused(w, x.as_subclass(_OnCard))
    assert tuple(y.shape) == (rows, n)
    (name, args), = fake_entries
    if rows == 1:
        assert name == "matmul_q8_0" and not seen
        return
    assert name == "matmul_q8_0_mma" and _build.LAUNCHES[name] == 1
    (_, fmt, (xq, xd, kind), _, _), = seen
    assert fmt is None and kind == 0 and xd.dtype == torch.float16
    got = (xq.float().reshape(rows, -1, 32) * xd.float()[..., None])
    assert torch.equal(got.reshape(rows, k),
                       dequantize(quantize_activations(x, GType.Q8_0)))
    assert args[:4] == (None, xq.data_ptr(), xd.data_ptr(), 0)
    splits = mq.q8_mma_splits(n, k, mq.H100_SMS)
    assert args[8:13] == (rows, n, k, mq.MMA_ROWS_Q8, splits)
    assert args[7] is None
    assert mq._mma_plan("matmul_q8_0_mma", True, rows, n, k, mq.H100_SMS) \
        == ([mq.MMA_ROWS_Q8], splits, 0)


def test_q8_0_plan_and_alignment(fake_entries):
    """f32 x at a narrow weight takes the 64-row tile, one launch and no
    scratch; at a weight whose 128-row tiles alone fill the SMs (the LM
    head) the shared tile, split kernel and scratch; the other sources name
    no tile. The int8 route refuses Q8 values that are not 16-byte
    aligned."""
    from ggmlsharp_tpu_torch.quant.formats import QTensor

    assert mq._mma_plan("matmul_q8_0_mma", False, 5, 768, 768, 132) == (
        [mq.MMA_ROWS_Q8], 3, 0)
    assert mq._mma_plan("matmul_q8_0_mma", False, 5, 50257, 768, 132) == (
        [mq.MMA_ROWS], 1, mq._mma_scratch_bytes(5, 50257, 768, 1, 3))
    # 132 tiles of 128 rows: wide enough; 131: not
    assert mq._mma_plan("matmul_q8_0_mma", False, 2, 132 * 128, 768,
                        132)[0] == [mq.MMA_ROWS]
    assert mq._mma_plan("matmul_q8_0_mma", False, 2, 131 * 128, 768,
                        132)[0] == [mq.MMA_ROWS_Q8]
    assert mq._mma_plan("matmul_q4_0_mma", True, 5, 768, 768, 132) == (
        [], 3, mq._mma_scratch_bytes(5, 768, 768, 3, 1))
    w = _q8_weight(256, 256, 1)
    buf = torch.zeros(2 * 256 + 16, dtype=torch.int8)
    xq = buf[4:4 + 2 * 256].view(2, 256).as_subclass(_OnCard)
    aq = QTensor(GType.Q8_0, (2, 256),
                 {"qs": xq, "d": torch.ones((2, 8), dtype=torch.float16)})
    with pytest.raises(ValueError):
        mq.mma_q8_matmul(w, aq)
    assert not fake_entries


@pytest.mark.parametrize("n,k,sms,want", [
    (2304, 768, 132, 3),      # 124M c_attn: 36 tiles of 64 rows, 3 chunks
    (768, 768, 132, 3),       # 124M c_proj
    (3840, 1280, 132, 2),     # 774M c_attn: 60 tiles; 5 chunks go 3 + 2
    (1280, 1280, 132, 5),     # 774M c_proj
    (768, 3072, 132, 6),      # 12 chunks: 8 wanted, evened to 6 x 2
    (50257, 768, 132, 1),     # the LM head: 786 tiles
    (4096, 4096, 132, 2),
    (22016, 4096, 132, 1),
    (4096, 11008, 132, 2),
    (768, 768, 33, 2),        # 12 tiles want 2 on a quarter of the SMs
    (2304, 768, 1, 1),
])
def test_q8_mma_splits(n, k, sms, want):
    assert mq.q8_mma_splits(n, k, sms) == want


def test_q8_mma_splits_reads_no_rows_and_refuses_nonsense():
    assert list(inspect.signature(mq.q8_mma_splits).parameters) == [
        "n", "k", "sms"]
    for bad in ((0, 768, 132), (768, 0, 132), (768, 768, 0)):
        with pytest.raises(ValueError):
            mq.q8_mma_splits(*bad)


# --- the fused SwiGLU MLP (kernel 9): one row on the b = 1 instance, more
# on the multi-row one (split, gate/up mma, merge_gate, down mma, merge) ----

def _silu_pair(E, F, seed):
    gen = torch.Generator().manual_seed(seed)
    w1 = quantize(torch.randn((2 * F, E), generator=gen) * 0.1, GType.Q4_0)
    w2 = quantize(torch.randn((E, F), generator=gen) * 0.1, GType.Q4_0)
    return w1, w2, gen


@pytest.mark.parametrize("E,F", [(256, 512), (384, 640)])
@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 5, 16, 64])
def test_mlp_route_by_rows(fake_entries, monkeypatch, E, F, quantize_acts,
                           rows):
    """One row: the b = 1 entry with f32 x (the dequantized round trip
    under quantize_acts). More: the multi-row entry with f32 x, or the Q8_0
    values and f16 scales themselves, the splits mma_splits gives each
    product (N, K, SMs) and a scratch of _mlp_scratch_bytes; each instance
    its own counter."""
    sized = []
    real = mf._mlp_scratch_bytes
    monkeypatch.setattr(mf, "_mlp_scratch_bytes",
                        lambda *a: sized.append(a) or real(*a))
    w1, w2, gen = _silu_pair(E, F, rows)
    x = torch.randn((rows, E), generator=gen)
    y = mf.flash_ff_silu_q4(w1, w2, x.as_subclass(_OnCard),
                            quantize_acts=quantize_acts)
    assert tuple(y.shape) == (rows, E)
    (name, args), = fake_entries
    mma = rows >= mq.MMA_MIN_ROWS
    assert name == ("mlp_fused_silu_q4_mma" if mma else "mlp_fused_silu_q4")
    assert _build.LAUNCHES[name] == 1 and sum(_build.LAUNCHES.values()) == 1
    weights = (w1["qs"].data_ptr(), w1["d"].data_ptr(), w2["qs"].data_ptr(),
               w2["d"].data_ptr())
    if not mma:
        # x, qs1, d1, qs2, d2, a, y, B, E, F, xa, sync, stream
        assert args[1:5] == weights and args[7:10] == (1, E, F)
        assert not sized
        return
    # x, xq, xd, qs1, d1, qs2, d2, y, scratch, B, E, F, splits1, splits2, stream
    assert args[3:7] == weights and args[8] is not None
    s1 = mq.mma_splits(2 * F, E, mq.H100_SMS)
    s2 = mq.mma_splits(E, F, mq.H100_SMS)
    assert args[9:14] == (rows, E, F, s1, s2)
    assert (args[0] is None) == quantize_acts
    assert (args[1] is None) == (args[2] is None) == (not quantize_acts)
    assert sized == [(rows, E, F, s1, s2, 1 if quantize_acts else 3)]


@pytest.mark.parametrize("rows", [2, 16])
def test_mlp_hands_the_q8_values(fake_entries, monkeypatch, rows):
    """Under quantize_acts the multi-row entry gets the int8 values and f16
    block scales of quantize_activations(x, Q4_0), which reproduce the
    rounded activations exactly, not a dequantized f32 copy."""
    seen = []
    real = mf._launch_silu_mma
    monkeypatch.setattr(mf, "_launch_silu_mma",
                        lambda *a: seen.append(a) or real(*a))
    w1, w2, gen = _silu_pair(256, 512, rows)
    x = torch.randn((rows, 256), generator=gen)
    mf.flash_ff_silu_q4(w1, w2, x.as_subclass(_OnCard))
    (aq, _, _, _), = seen
    (_, args), = fake_entries
    assert aq.gtype == GType.Q8_0 and aq["d"].dtype == torch.float16
    assert args[:3] == (None, aq["qs"].data_ptr(), aq["d"].data_ptr())
    assert torch.equal(dequantize(aq),
                       dequantize(quantize_activations(x, GType.Q4_0)))


@pytest.mark.parametrize("quantize_acts", [False, True])
def test_mlp_refuses_65_rows(fake_entries, quantize_acts):
    """The 64-row gate (_MAX_FUSED_B) holds for both instances' wrapper."""
    w1, w2, gen = _silu_pair(256, 512, 65)
    x = torch.randn((65, 256), generator=gen).as_subclass(_OnCard)
    with pytest.raises(ValueError):
        mf.flash_ff_silu_q4(w1, w2, x, quantize_acts=quantize_acts)
    assert not fake_entries


def test_mlp_one_row_of_q8_values_is_refused(fake_entries):
    """The b = 1 instance takes f32 x only."""
    w1, w2, gen = _silu_pair(256, 512, 1)
    aq = quantize_activations(torch.randn((1, 256), generator=gen),
                              GType.Q4_0)
    aq.planes["qs"] = aq["qs"].as_subclass(_OnCard)
    with pytest.raises(ValueError):
        mf.mlp_fused_silu_q4(aq, w1, w2)
    assert not fake_entries


def test_mlp_scratch_bytes():
    """The gate/up pass's activations (one plane for Q8_0, with its scales;
    three for f32 x) and its splits of [b, 2F] sums; then the gated
    product's three planes and sums, and the down pass's partial sums when
    it splits. Every part a multiple of 16 bytes."""
    # b 2, E 256, F 512, one gate/up split, two down splits, Q8_0 x:
    # 1024 + 128 + 64 + 8192, then 6144 + 256 + 4096
    assert mf._mlp_scratch_bytes(2, 256, 512, 1, 2, 1) == 9408 + 10496
    # f32 x: three planes, no scales; one down split: no partial sums
    assert mf._mlp_scratch_bytes(2, 256, 512, 3, 1, 3) == \
        3072 + 128 + 3 * 8192 + 6144 + 256
    assert mf._mlp_scratch_bytes(3, 384, 640, 2, 3) % 16 == 0


# --- the fused GELU MLP (kernel 8): one row on the b = 1 instance, more on
# the multi-row one (W1 on the int8 route or f32 planes, gelu(sum + b1) in
# its epilogue; W2 over h, + b2 in its epilogue) ------------------------------

def _gelu_pair(E, seed, bias_dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    w1 = quantize(torch.randn((4 * E, E), generator=gen) * 0.1, GType.Q8_0)
    w2 = quantize(torch.randn((E, 4 * E), generator=gen) * 0.1, GType.Q8_0)
    b1 = (torch.randn(4 * E, generator=gen) * 0.1).to(bias_dtype)
    b2 = (torch.randn(E, generator=gen) * 0.1).to(bias_dtype)
    return w1, b1, w2, b2, gen


@pytest.mark.parametrize("E", [256, 384])
@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 2, 5, 16, 64])
def test_gelu_mlp_route_by_rows(fake_entries, monkeypatch, E, quantize_acts,
                                mode, rows):
    """One row: the b = 1 entry with f32 x (the dequantized round trip
    under quantize_acts). More: the multi-row entry with f32 x, or the Q8_0
    values and f16 scales themselves, and q8_mma_splits' splits for each
    product (N, K, SMs alone); each instance its own counter. rx, the
    rounding of f32 x, is set by mm_dot "bf16" and never for the round
    trip's values."""
    from ggmlsharp_tpu_torch.kernels import config as kcfg

    monkeypatch.setattr(kcfg, "_mm_dot", mode)
    w1, b1, w2, b2, gen = _gelu_pair(E, rows)
    x = torch.randn((rows, E), generator=gen)
    y = mf.flash_ff_q8(w1, b1, w2, b2, x.as_subclass(_OnCard),
                       quantize_acts=quantize_acts)
    assert tuple(y.shape) == (rows, E)
    (name, args), = fake_entries
    mma = rows >= mq.MMA_MIN_ROWS
    assert name == ("mlp_fused_q8_mma" if mma else "mlp_fused_q8")
    assert _build.LAUNCHES[name] == 1 and sum(_build.LAUNCHES.values()) == 1
    rx = int(mode == "bf16" and not quantize_acts)
    weights = (w1["qs"].data_ptr(), w1["d"].data_ptr(), b1.data_ptr(),
               w2["qs"].data_ptr(), w2["d"].data_ptr(), b2.data_ptr())
    if not mma:
        # x, qs1, d1, b1, qs2, d2, b2, xh, y, B, K1, N1, N2, bias_bf16, rx,
        # sync, plan, stream
        assert args[1:7] == weights
        assert args[9:15] == (1, E, 4 * E, E, 0, rx)
        return
    # x, xq, xd, qs1, d1, b1, qs2, d2, b2, h, y, B, K1, N1, N2, bias_bf16,
    # splits1, splits2, rx, stream
    assert args[3:9] == weights and args[9] is not None
    assert args[11:16] == (rows, E, 4 * E, E, 0)
    assert args[16:19] == (mq.q8_mma_splits(4 * E, E, mq.H100_SMS),
                           mq.q8_mma_splits(E, 4 * E, mq.H100_SMS), rx)
    assert (args[0] is None) == quantize_acts
    assert (args[1] is None) == (args[2] is None) == (not quantize_acts)


@pytest.mark.parametrize("rows", [2, 16, 64])
def test_gelu_mlp_hands_the_q8_values(fake_entries, monkeypatch, rows):
    """Under quantize_acts the multi-row entry gets the int8 values and f16
    block scales of quantize_activations(x, Q8_0), which reproduce the
    rounded activations exactly, not a dequantized f32 copy; bf16 biases
    go as they are (bias_bf16 1)."""
    seen = []
    real = mf.mlp_fused_q8
    monkeypatch.setattr(mf, "mlp_fused_q8",
                        lambda *a, **k: seen.append(a) or real(*a, **k))
    w1, b1, w2, b2, gen = _gelu_pair(256, rows, torch.bfloat16)
    x = torch.randn((rows, 256), generator=gen)
    mf.flash_ff_q8(w1, b1, w2, b2, x.as_subclass(_OnCard))
    (aq, *_), = seen
    (_, args), = fake_entries
    assert aq.gtype == GType.Q8_0 and aq["d"].dtype == torch.float16
    assert args[:3] == (None, aq["qs"].data_ptr(), aq["d"].data_ptr())
    assert args[5] == b1.data_ptr() and args[15] == 1
    assert torch.equal(dequantize(aq),
                       dequantize(quantize_activations(x, GType.Q8_0)))


@pytest.mark.parametrize("quantize_acts", [False, True])
def test_gelu_mlp_refuses_65_rows_and_one_row_of_q8_values(fake_entries,
                                                           quantize_acts):
    """The 64-row gate holds for both instances; the b = 1 instance takes
    f32 x only."""
    w1, b1, w2, b2, gen = _gelu_pair(256, 65)
    x = torch.randn((65, 256), generator=gen).as_subclass(_OnCard)
    with pytest.raises(ValueError):
        mf.flash_ff_q8(w1, b1, w2, b2, x, quantize_acts=quantize_acts)
    aq = quantize_activations(x[:1].as_subclass(torch.Tensor), GType.Q8_0)
    aq.planes["qs"] = aq["qs"].as_subclass(_OnCard)
    with pytest.raises(ValueError):
        mf.mlp_fused_q8(aq, w1, b1, w2, b2)
    assert not fake_entries
