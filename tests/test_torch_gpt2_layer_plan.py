"""Kernel 11's shared-memory plan (kernels/gpt2_layer.py::smem_plan) on the
CPU: the layout the wrapper hands csrc/gpt2_layer.cu, at GPT-2 124M, 355M,
774M and at E 1536, H 12, F 6144 (a width the route's gate passes whose
shares do not fit at once), on 132 CTAs of 232,448 bytes (an H100's SMs and
the shared memory a CTA may opt into).

  * every offset and every copy is a multiple of 16 bytes (the bulk copies'
    rule), the scale ranges widened to 16-byte bounds inside their plane and
    inside their piece;
  * the pieces cover each weight's share once, and the CTAs' shares cover
    every row once;
  * 124M to 774M fit without reuse; E 1536 reuses ring bytes, and a piece
    that overwrites another's waits for a release no earlier than its;
  * the plan's constants are the kernel's (``csrc/gpt2_layer.cu`` and the
    weight-share code it includes, ``csrc/shares.cuh``).
"""
import os
import re

import pytest

from ggmlsharp_tpu_torch.kernels import _build, gpt2_layer
from ggmlsharp_tpu_torch.kernels.gpt2_layer import (piece_bytes,
                                                    smem_plan)

CTAS, SMEM = 132, 232448
WIDTHS = {"124M": (768, 12), "355M": (1024, 16), "774M": (1280, 20),
          "E1536": (1536, 12)}


def _mats(E, F):
    return ((3 * E, E), (E, E), (F, E), (E, F))


def _share(n, c, g=CTAS):
    return n * c // g, n * (c + 1) // g


@pytest.fixture(params=sorted(WIDTHS))
def width(request):
    E, H = WIDTHS[request.param]
    return request.param, E, 4 * E, H, smem_plan(E, 4 * E, H, CTAS, SMEM)


def test_offsets_and_copies_are_16_byte_multiples(width):
    _, E, F, H, plan = width
    assert plan.smem <= SMEM
    for off in (plan.red, plan.att, plan.bar, plan.ring):
        assert off % 16 == 0
    assert plan.red >= max(E, F) * 4
    assert plan.att - plan.red >= max(plan.rows) * 16 * 4
    assert plan.bar - plan.att >= (3 * 16 + 19 * (E // H) + 2 * E) * 4
    assert plan.ring - plan.bar >= 16 * len(plan.pieces)
    mats = _mats(E, F)
    for w, i0, rows, off, _, _, _ in plan.pieces:
        n, k = mats[w]
        assert off % 16 == 0 and (rows * k) % 16 == 0
        assert plan.ring + off + piece_bytes(rows, k) <= plan.smem
        for c in range(CTAS):  # the scales a CTA copies into this piece
            lo, hi = _share(n, c)
            r = max(0, min(rows, hi - lo - i0))
            if r == 0:
                continue
            start = (lo + i0) * (k // 16)
            d0, d1 = start // 16 * 16, -(-(start + r * k // 16) // 16) * 16
            assert (d1 - d0) % 16 == 0 and d1 <= n * k // 16
            assert rows * k + (d1 - d0) <= piece_bytes(rows, k)


def test_pieces_and_shares_cover_every_row_once(width):
    _, E, F, _, plan = width
    for w, (n, _) in enumerate(_mats(E, F)):
        mine = [p for p in plan.pieces if p[0] == w]
        assert plan.pieces[plan.first[w]:plan.first[w + 1]] == tuple(mine)
        covered = [i for _, i0, rows, *_ in mine
                   for i in range(i0, i0 + rows)]
        assert covered == list(range(plan.rows[w]))
        owned = []
        for c in range(CTAS):
            lo, hi = _share(n, c)
            assert hi - lo <= plan.rows[w]
            owned += range(lo, hi)
        assert owned == list(range(n))


def test_shares_fit_at_once_up_to_774m_and_e1536_reuses(width):
    name, E, F, _, plan = width
    if name == "E1536":
        assert plan.reuses
        assert sum(piece_bytes(r, _mats(E, F)[w][1])
                   for w, _, r, *_ in plan.pieces) > plan.smem - plan.ring
    else:
        assert not plan.reuses
        assert len(plan.pieces) == 4  # one piece a weight, all in flight


def test_a_piece_waits_for_every_piece_it_overwrites(width):
    _, E, F, _, plan = width
    mats = _mats(E, F)
    span = [(off, off + piece_bytes(rows, mats[w][1]))
            for w, _, rows, off, *_ in plan.pieces]
    for j, (_, _, _, _, wait, _, _) in enumerate(plan.pieces):
        assert wait < j
        for i in range(j):
            if span[i][0] < span[j][1] and span[j][0] < span[i][1]:
                assert wait >= i, (i, j, plan.pieces)


def test_units_cover_their_piece_and_split_at_most_the_warps(width):
    """Every piece's (rows a unit, splits): 1 or 2 rows, at most one split a
    consumer warp and a step, and the choice ``unit_plan`` makes."""
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import unit_plan

    _, E, F, _, plan = width
    for w, _, rows, _, _, rw, splits in plan.pieces:
        k = _mats(E, F)[w][1]
        assert rw in (1, 2) and 1 <= splits <= min(16, -(-k // 256))
        assert (rw, splits) == unit_plan(rows, k)


@pytest.mark.parametrize("rows,k,want", [(18, 768, (2, 1)), (39, 1280, (1, 1)),
                                         (10, 5120, (2, 3)), (0, 768, (2, 1))])
def test_unit_plan_takes_the_fewest_rounds(rows, k, want):
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import unit_plan

    assert unit_plan(rows, k) == want


def test_plan_ints_are_what_the_kernel_reads():
    E, H = WIDTHS["E1536"]
    plan = smem_plan(E, 4 * E, H, CTAS, SMEM)
    ints = plan.ints()
    assert ints[:7] == [len(plan.pieces), plan.red, plan.att, plan.bar,
                        plan.ring, plan.smem, CTAS]
    assert ints[7:12] == list(plan.first) and plan.first[4] == len(plan.pieces)
    assert len(ints) == 12 + 7 * len(plan.pieces)
    # the kernel's constants, and those of the header its plan code lives in
    src = ""
    for name in ("gpt2_layer.cu", "shares.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            src += f.read()
    assert int(re.search(r"constexpr int CW = (\d+);", src)[1]) \
        == gpt2_layer._CONSUMER_WARPS
    assert int(re.search(r"constexpr int MAX_PIECES = (\d+);", src)[1]) \
        == gpt2_layer._MAX_PIECES
    assert len(plan.pieces) <= gpt2_layer._MAX_PIECES
    assert re.search(r"constexpr int PIECE_INTS = 7;", src)
    assert "H_LEN = H_FIRST + 5" in src


@pytest.mark.parametrize("E,F,H", [(768, 3000, 12), (768, 3072, 7),
                                   (1000, 4000, 10)])
def test_plan_refuses_widths_the_kernel_does_not_take(E, F, H):
    with pytest.raises(ValueError):
        smem_plan(E, F, H, CTAS, SMEM)
