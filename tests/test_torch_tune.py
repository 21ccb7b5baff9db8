"""The port's tune table and its dispatch against the JAX package's lookup
on the CPU.

Each case writes a JAX table (``kt<B>:NxK`` / ``g<int>:NxK`` ->
[tile, nc, kp]) and the port's table of the same shape of decision
(``<kernel>:NxK`` / ``g<int>:NxK`` -> [warps, rows_per_warp]); both lookups
must decide alike: the format's entry over the class entry, a stale or
illegal entry -> None, a missing or corrupt file -> None, and the table
named by GGML_TPU_TUNE.
"""
import json
import os

import pytest
import torch

from ggmlsharp_tpu.kernels import tune as jtune
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.kernels import _build, matmul_q, tune

N, K = 4096, 4096
G = int(GType.Q4_0)
# case -> (JAX table, port table, JAX answer, port answer); None: no table
# file, "corrupt": bad JSON
CASES = {
    "gtype_wins": ({f"kt6:{N}x{K}": [512, 2, K], f"g{G}:{N}x{K}": [256, 4, K]},
                   {f"matmul_q4_0:{N}x{K}": [8, 1],
                    f"g{G}:{N}x{K}": [4, 4]},
                   (256, 4, K), (4, 4)),
    "class_entry": ({f"kt6:{N}x{K}": [512, 2, K, 16.0]},
                    {f"matmul_q4_0:{N}x{K}": [8, 2, 16.0]},
                    (512, 2, K), (8, 2)),
    "no_entry": ({f"kt6:{N}x{2 * K}": [512, 2, 2 * K]},
                 {f"matmul_q4_0:{N}x{2 * K}": [8, 2]}, None, None),
    "stale_entry": ({f"kt6:{N}x{K}": [384, 2, K]},     # N % tile != 0
                    {f"matmul_q4_0:{N}x{K}": [3, 2]},  # never compiled
                    None, None),
    "stale_gtype_entry": ({f"kt6:{N}x{K}": [512, 2, K],
                           f"g{G}:{N}x{K}": [512, 3, K]},  # kp % nc
                          {f"matmul_q4_0:{N}x{K}": [8, 2],
                           f"g{G}:{N}x{K}": [4, 8]},
                          None, None),
    "missing_file": (None, None, None, None),
    "corrupt_file": ("corrupt", "corrupt", None, None),
}


def _write(path, table):
    if table is None:
        return
    with open(path, "w") as f:
        f.write("{not json" if table == "corrupt" else json.dumps(table))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_decides_as_jax(tmp_path, monkeypatch, case):
    jt, pt, jwant, pwant = CASES[case]
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    _write(jpath, jt)
    _write(ppath, pt)
    monkeypatch.setenv("GGML_TPU_TUNE", str(jpath))
    jgot = jtune.lookup(6, N, K, gtype=GType.Q4_0)
    monkeypatch.setenv("GGML_TPU_TUNE", str(ppath))
    pgot = tune.lookup("matmul_q4_0", N, K, gtype=GType.Q4_0)
    assert jgot == jwant and pgot == pwant
    assert (jgot is None) == (pgot is None)
    # the wrappers' choice: the table's pair at b = 1, else the default
    assert matmul_q.geometry("matmul_q4_0", N, K, GType.Q4_0) == \
        (pwant or tune.DEFAULT)


@pytest.mark.parametrize("b", [2, 8, 16])
def test_geometry_reads_the_table_at_b1_only(tmp_path, monkeypatch, b):
    """The table was timed on the b = 1 instance; a launch of more rows
    runs the other instance at the default pair."""
    path = tmp_path / "t.json"
    _write(path, {f"matmul_q4_0:{N}x{K}": [8, 1],
                  f"g{int(GType.Q6_K)}:{N}x{K}": [4, 1]})
    monkeypatch.setenv("GGML_TPU_TUNE", str(path))
    assert matmul_q.geometry("matmul_q4_0", N, K, GType.Q4_0) == (8, 1)
    assert matmul_q.geometry("matmul_q", N, K, GType.Q6_K, 1) == (4, 1)
    assert matmul_q.geometry("matmul_q4_0", N, K, GType.Q4_0, b) == \
        tune.DEFAULT
    assert matmul_q.geometry("matmul_q", N, K, GType.Q6_K, b) == \
        tune.DEFAULT


def test_tune_env_names_the_table(tmp_path, monkeypatch):
    """GGML_TPU_TUNE overrides the packaged table; each path names its own
    table, read once."""
    one, two = tmp_path / "one.json", tmp_path / "two.json"
    _write(one, {"matmul_q8_0:768x768": [8, 4]})
    _write(two, {"matmul_q8_0:768x768": [4, 1, 12.5]})
    monkeypatch.setenv("GGML_TPU_TUNE", str(one))
    assert tune.table_path() == str(one)
    assert tune.lookup("matmul_q8_0", 768, 768) == (8, 4)
    monkeypatch.setenv("GGML_TPU_TUNE", str(two))
    assert tune.lookup("matmul_q8_0", 768, 768) == (4, 1)
    monkeypatch.setenv("GGML_TPU_TUNE", str(one))
    assert tune.lookup("matmul_q8_0", 768, 768) == (8, 4)
    monkeypatch.delenv("GGML_TPU_TUNE")
    assert tune.table_path() == tune.PACKAGED


def test_packaged_table_is_legal():
    """Every entry of tune_h100.json names a geometry compiled into its
    dequant-matmul kernel (a format's entry: that format's kernel) at a
    shape; the table says on which card it was measured."""
    with open(tune.PACKAGED) as f:
        table = json.load(f)
    assert isinstance(table.get("_card"), str) and table["_card"]
    formats = {int(g) for g in matmul_q.KERNEL_OF}
    for key, ent in table.items():
        if key.startswith("_"):
            continue
        kind, shape = key.split(":")
        n, k = (int(v) for v in shape.split("x"))
        assert n > 0 and k > 0 and k % 32 == 0, key
        assert kind in tune.KERNELS or (kind[0] == "g"
                                        and int(kind[1:]) in formats), key
        kern = kind if kind in tune.KERNELS \
            else matmul_q.KERNEL_OF[GType(int(kind[1:]))]
        assert tune.legal(ent, kern) is not None, key
    for pair in tune.GEOMETRIES:  # each pair is an instance of every source
        assert pair[0] in (4, 8) and pair[1] in (1, 2, 4)
    assert set(tune.GEOMETRIES) <= set(tune.VEC_GEOMETRIES)
    for src, kern in (("matmul_q4_0.cu", "matmul_q4_0"),
                      ("matmul_q8_0.cu", "matmul_q8_0"),
                      ("matmul_q.cu", "matmul_q")):
        with open(os.path.join(_build.CSRC, src)) as f:
            text = f.read()
        for warps, rpw in tune.GEOMETRIES_OF[kern]:
            assert f"case {warps} * 16 + {rpw}:" in text, (src, warps, rpw)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = property(lambda self: True)


@pytest.mark.parametrize("geom", [(3, 2), (4, 3), (16, 3)])
def test_launch_refuses_a_geometry_never_compiled(monkeypatch, geom):
    """An unknown pair from a hand-edited table or GGML_TPU_TUNE file is
    refused before any build or launch."""
    from ggmlsharp_tpu_torch.models.llama import random_q4_0

    def no_nvcc():
        raise AssertionError("reached the build")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    w = random_q4_0(64, 256, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros((1, 256)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="not compiled"):
        matmul_q.q4_0_matmul(x, w["qs"], w["d"], geom)
    monkeypatch.setattr(tune, "lookup", lambda *a, **k: geom)
    with pytest.raises(ValueError, match="not compiled"):
        matmul_q.q4_0_matmul(x, w["qs"], w["d"])
