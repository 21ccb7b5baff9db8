"""The wrappers of the dequant-matmuls at several activation rows: the rows
that take the multi-row instance of ``csrc/matmul_q4_0.cu`` and
``csrc/matmul_q.cu`` (``csrc/dq_mma.cuh``: from
``kernels.matmul_q.MMA_MIN_ROWS`` rows on). Their plain version is held
against the TPU kernels at 3-16 rows in ``test_torch_matmul_formats.py``.

  * The route a wrapper takes at each b, what it hands the multi-row entry
    (the K splits, the scratch for them) and the counters it bumps, with a
    stand-in for the C entry: the CUDA kernel itself runs only on the card
    (``chip_smoke.py`` holds it against the plain version there).
  * ``mma_splits`` as a function of (N, K, SM count) alone.
"""
import contextlib
import inspect

import pytest
import torch

from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.kernels import _build
from ggmlsharp_tpu_torch.kernels import matmul_q as mq


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
        # ..., y, scratch, B, N, K, splits, stream
        scratch, (b_, n_, k_, splits) = args[-6], args[-5:-1]
        assert (b_, n_, k_) == (rows, n, k)
        assert splits == mq.mma_splits(n, k, mq.H100_SMS) == 2
        assert scratch is not None
    else:
        assert args[-3:-1] == geom  # warps, rows a warp


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
    args = {args[-5:-1] for _, args in fake_entries}  # B, N, K, splits
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
    from ggmlsharp_tpu_torch.ops import quantize_activations
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

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
