"""The b = 1 instance of the dequant-matmuls (``csrc/dq_vec.cuh``, built into
``csrc/matmul_q4_0.cu`` and ``csrc/matmul_q.cu``) on the CPU, where its
kernel cannot run (``chip_smoke.py`` holds it against the plain version on
the card):

  * the plain version at one activation row against the JAX package's TPU
    kernel 6 (``_call_kernel``, every format), with and without the Q8
    activation round trip, at the tolerance of
    ``test_torch_matmul_formats.py``;
  * the route with a stand-in C entry: one row reaches the b = 1 entry with
    the operands, the mm_dot mode and the tune table's launch geometry
    (16-warp pairs included), two rows the multi-row entry; a quant plane
    the 16-byte loads cannot take is refused before any launch;
  * the geometry sets: the b = 1 sources compile ``tune.VEC_GEOMETRIES``,
    Q8_0's source ``tune.GEOMETRIES`` only, and ``tune.legal`` reads the
    kernel's set;
  * the autotuner: its plan and its sweep take each kernel's own pairs, and
    the sweep writes a whole table;
  * the probe's unpack variants: ``Q4_UNPACK`` stays a tunable that
    ``matmul_q4_0.cu`` declares with ``#ifndef``.
"""
import contextlib
import json
import os
import re

import pytest
import torch

from ggmlsharp_tpu import GType as JGType
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.kernels import matmul_q as jmq
from ggmlsharp_tpu.quant.formats import to_storage_order
from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.kernels import _build, autotune, tune
from ggmlsharp_tpu_torch.kernels import matmul_q as mq
from ggmlsharp_tpu_torch.ops import mul_mat_q
from ggmlsharp_tpu_torch.probes import dq_variants
from test_torch_matmul_formats import K, N, _check, _jax_acts, _pair, _x

FORMATS = ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q5_0", "Q5_1", "Q4_K", "Q6_K"]


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    """The JAX kernels' exact mode (Precision.HIGHEST dots)."""
    monkeypatch.setattr(jkcfg, "_mm_dot", "f32")


@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_matches_tpu_kernel_6_one_row(fmt, quantize_acts):
    """The b = 1 instance's plain version (ops.mul_mat_q) at one row."""
    jw, tw = _pair(fmt)
    x = _x(1, seed=11)
    _, keys, bs = jmq._DEQUANT_TILE[JGType[fmt]]
    want = jmq._call_kernel(to_storage_order(_jax_acts(x, fmt, quantize_acts),
                                             bs), dict(jw.planes),
                            JGType[fmt], N, K, keys, "f32")
    _check(mul_mat_q(tw, torch.from_numpy(x), quantize_acts=quantize_acts),
           want)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = property(lambda self: True)


@pytest.fixture
def fake_entries(monkeypatch):
    """Every C entry replaced by a recorder returning 0, the SM count fixed,
    a stream stand-in, fresh launch counters; yields the calls."""
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


def _weight(fmt, n=64, k=512, seed=3):
    return quantize(torch.randn((n, k), generator=torch.Generator()
                                .manual_seed(seed)) * 0.1, GType[fmt])


def _call(fmt, x, w, mode):
    if fmt == "Q4_0":
        return mq.q4_0_matmul(x, w["qs"], w["d"], mode=mode)
    return mq.q_matmul(x, w, mode=mode)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_one_row_takes_the_vec_entry(fake_entries, tmp_path, monkeypatch,
                                     fmt, mode):
    """One row: the b = 1 entry, with x, the weight's planes in the entry's
    order, rx of the mode and the table's pair (a 16-warp one); two rows:
    the multi-row entry, and the pair reaches no launch."""
    n, k = 64, 512
    w = _weight(fmt, n, k)
    kern = mq.KERNEL_OF[GType[fmt]]
    key = f"{kern}:{n}x{k}" if fmt == "Q4_0" else f"g{int(GType[fmt])}:{n}x{k}"
    path = tmp_path / "t.json"
    path.write_text(json.dumps({key: [16, 2]}))
    monkeypatch.setenv("GGML_TPU_TUNE", str(path))
    x = torch.randn((1, k)).as_subclass(_OnCard)
    y = _call(fmt, x, w, mode)
    assert tuple(y.shape) == (1, n)
    (name, args), = fake_entries
    assert name == kern and _build.LAUNCHES[kern] == 1
    assert _build.GEOMETRY_LAUNCHES == {(kern, n, k, 16, 2, 1): 1}
    # ..., B, N, K, warps, rpw, rx, stream
    assert args[-7:-1] == (1, n, k, 16, 2, int(mode == "bf16"))
    lead = 0 if fmt == "Q4_0" else 1  # q_matmul: the format id first
    if lead:
        assert args[0] == int(GType[fmt])
    assert args[lead] == x.data_ptr()
    planes = ("qs", "d") if fmt == "Q4_0" else mq._PLANES[GType[fmt]]
    assert args[lead + 1:lead + 1 + len(planes)] == tuple(
        w[p].data_ptr() for p in planes)
    fake_entries.clear()
    _call(fmt, torch.randn((2, k)).as_subclass(_OnCard), w, mode)
    (name, _), = fake_entries
    assert name == f"{kern}_mma"


@pytest.mark.parametrize("fmt,plane", [("Q4_0", "qs"), ("Q4_K", "qs"),
                                       ("Q6_K", "ql"), ("Q6_K", "qh")])
def test_one_row_refuses_a_plane_off_16_bytes(fake_entries, fmt, plane):
    """The b = 1 instance loads the quant planes 16 bytes at a time; a plane
    4-byte aligned only (the multi-row instance takes it) is refused at one
    row before any launch."""
    n, k = 64, 512
    w = _weight(fmt, n, k)
    p = w[plane]
    buf = torch.zeros(p.numel() * p.element_size() + 16, dtype=torch.uint8)
    view = buf[4:4 + p.numel() * p.element_size()].view(p.dtype).view(p.shape)
    view.copy_(p)
    w.planes[plane] = view
    x = torch.randn((1, k)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="aligned"):
        _call(fmt, x, w, "f32")
    assert not fake_entries


def test_geometry_sets():
    """The b = 1 sources hold VEC_GEOMETRIES (GEOMETRIES and 16 warps),
    Q8_0's GEOMETRIES alone; legal() reads the kernel's set, and a pair
    outside it never reaches a launch."""
    assert set(tune.GEOMETRIES) < set(tune.VEC_GEOMETRIES)
    assert {w for w, _ in tune.VEC_GEOMETRIES} == {4, 8, 16}
    assert tune.GEOMETRIES_OF["matmul_q8_0"] == tune.GEOMETRIES
    for src, kern in (("matmul_q4_0.cu", "matmul_q4_0"),
                      ("matmul_q.cu", "matmul_q"),
                      ("matmul_q8_0.cu", "matmul_q8_0")):
        with open(os.path.join(_build.CSRC, src)) as f:
            cases = set(re.findall(r"case (\d+) \* 16 \+ (\d+):", f.read()))
        assert cases == {(str(w), str(r)) for w, r in
                         tune.GEOMETRIES_OF[kern]}, src
    assert tune.legal([16, 2], "matmul_q4_0") == (16, 2)
    assert tune.legal([16, 2], "matmul_q") == (16, 2)
    assert tune.legal([16, 2], "matmul_q8_0") is None
    assert tune.legal([16, 2]) is None
    assert tune.legal([8, 4, 12.5]) == (8, 4)
    with pytest.raises(ValueError, match="not compiled"):
        mq._check_geometry("matmul_q8_0", (16, 2))
    assert mq._check_geometry("matmul_q4_0", (16, 2)) == (16, 2)


def test_table_lookup_per_kernel(tmp_path, monkeypatch):
    """A 16-warp entry is read for a b = 1 source and ignored (the default
    runs) for Q8_0's, which has no such instance."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"matmul_q4_0:256x512": [16, 4],
                                "matmul_q8_0:256x512": [16, 4],
                                "g14:256x512": [16, 1]}))
    monkeypatch.setenv("GGML_TPU_TUNE", str(path))
    assert mq.geometry("matmul_q4_0", 256, 512, GType.Q4_0) == (16, 4)
    assert mq.geometry("matmul_q", 256, 512, GType.Q4_K) == (16, 1)
    assert mq.geometry("matmul_q8_0", 256, 512, GType.Q8_0) == tune.DEFAULT


def test_autotune_plan_per_kernel(capsys):
    """The plan names every kernel's keys (every format of kernel A), each
    kernel at its compiled pairs."""
    assert autotune.main(["--device", "cpu"]) == 0
    plan = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    plan = plan["autotune_plan"]
    assert {k.split(":")[0] for k in plan["keys"]
            if not k.startswith("g")} == {"matmul_q4_0", "matmul_q8_0"}
    fmts = {int(k[1:].split(":")[0]) for k in plan["keys"]
            if k.startswith("g")}
    assert fmts == {int(g) for g, kern in mq.KERNEL_OF.items()
                    if kern == "matmul_q"}
    assert plan["geometries"] == {k: [list(g) for g in tune.GEOMETRIES_OF[k]]
                                  for k in tune.KERNELS}


def test_autotune_sweep_times_each_kernels_pairs(tmp_path, monkeypatch):
    """A sweep times each target at its kernel's pairs and writes a whole
    new table over the old one: no entry of an earlier sweep is kept."""
    from ggmlsharp_tpu_torch.probes import common

    out = tmp_path / "tune.json"
    out.write_text(json.dumps({"_card": "old", "matmul_q8_0:1x32": [8, 4]}))
    seen = {}

    def sweep_one(kernel, gtype, n, k, gen, dev, rounds=autotune.ROUNDS):
        # the last pair wins by more than the spread
        samples = {g: [1.0, 1.0] for g in tune.GEOMETRIES_OF[kernel]}
        samples[tune.GEOMETRIES_OF[kernel][-1]] = [0.5, 0.5]
        seen[kernel] = tuple(samples)
        return samples, 20, n * k

    monkeypatch.setattr(autotune, "sweep_one", sweep_one)
    monkeypatch.setattr(_build, "build", lambda *a, **k: {})
    monkeypatch.setattr(common, "card", lambda: "NVIDIA H100 80GB HBM3, 700 W")
    table, rows = autotune.run(str(out), torch.device("cpu"))
    assert seen == {k: tune.GEOMETRIES_OF[k] for k in tune.KERNELS}
    written = json.loads(out.read_text())
    assert "matmul_q8_0:1x32" not in written
    assert written["_card"].startswith("NVIDIA")
    assert written["matmul_q4_0:4096x4096"][:2] == [16, 4]
    assert written["matmul_q8_0:4096x4096"][:2] == [8, 4]
    assert len(rows) == len(autotune.targets())
    assert all(r["range_ms"][f"{w}x{r_}"] == 0.0 for r in rows
               for w, r_ in tune.GEOMETRIES_OF["matmul_q4_0"]
               if r["key"].startswith("matmul_q4_0"))


def test_q4_unpack_stays_a_declared_tunable():
    """The probe builds matmul_q4_0.cu with -DQ4_UNPACK=1 and =2: the source
    declares the macro with #ifndef, so set_defines takes its variants and
    refuses an undeclared one."""
    with open(os.path.join(_build.CSRC, "matmul_q4_0.cu")) as f:
        text = f.read()
    assert re.search(r"^#ifndef Q4_UNPACK$", text, re.M)
    assert "Q4_UNPACK" in _build.declared_macros("matmul_q4_0")
    for name, v in dq_variants.VARIANTS.items():
        assert _build._declared("matmul_q4_0",
                                dq_variants.variant_defines(name)) == (
            () if v == 0 else (f"Q4_UNPACK={v}",))
    with pytest.raises(ValueError, match="declares no"):
        _build._declared("matmul_q4_0", ("Q4_UNPACKED=1",))
