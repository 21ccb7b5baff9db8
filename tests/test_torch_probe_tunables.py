"""The -D tunables a probe builds a kernel with, on the CPU (sources and
tables only; nothing is compiled):

  * ``kernels.set_defines`` refuses a macro that the kernel's source does not
    declare (``#ifndef NAME``): such a build is the default kernel, and a
    probe would report its time under the variant's name;
  * every define of every table of ``scripts/probe_q8_kernels.py``, of
    ``probes/dq_variants.py`` and of ``probes/q8_acts.py`` is declared by
    its kernel's source;
  * the probe's kernel-8 variants call the wrapper at one row, the b = 1
    instance that their MLP_* macros shape.
"""
import importlib.util
import os
import types

import pytest
import torch

from ggmlsharp_tpu_torch.kernels import _build, set_defines
from ggmlsharp_tpu_torch.probes import dq_variants, q8_acts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_script():
    spec = importlib.util.spec_from_file_location(
        "probe_q8_kernels_script",
        os.path.join(ROOT, "scripts", "probe_q8_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _probe_script()


def _variants():
    """(kernel, table, variant, defines) of every probe table."""
    out = [(kernel, "probe_q8_kernels", variant, defines)
           for kernel, table in PROBE.TABLES.items()
           for variant, defines in table.items()]
    out += [("matmul_q4_0", "dq_variants", v, dq_variants.variant_defines(v))
            for v in dq_variants.VARIANTS]
    out += [(q8_acts.ENTRY, "q8_acts", v, q8_acts.variant_defines(v))
            for v in q8_acts.VARIANTS]
    return out


@pytest.mark.parametrize("kernel,table,variant,defines", _variants(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_probe_defines_are_declared_by_their_source(kernel, table, variant,
                                                    defines):
    declared = _build.declared_macros(kernel)
    for d in defines:
        assert d.split("=", 1)[0] in declared, (table, variant, d)
    try:  # the guard lets every one of them through
        set_defines(kernel, defines)
    finally:
        set_defines(kernel, ())


def test_probe_tables_name_every_cooperative_kernel():
    assert set(PROBE.TABLES) == {"mlp_fused_q8", "gpt2_layer",
                                 "mlp_fused_silu_q4", "llama_layer"}
    assert PROBE.LLAMA_VARIANTS is PROBE.TABLES["llama_layer"]
    assert PROBE.LAYER_VARIANTS is PROBE.TABLES["gpt2_layer"]
    assert ("LAYER_NO_MATVEC=1",) in PROBE.LAYER_VARIANTS.values()


@pytest.mark.parametrize("kernel,bad", [
    ("llama_layer", "LAYER_RW=4"),
    ("llama_layer", "LAYER_MAX_BLOCKS_SM=2"),
    ("gpt2_layer", "LAYER_RW=4"),
    ("mlp_fused_q8", "LAYER_CHUNKS=4"),
    ("matmul_q4_0", "Q8_ACTS=1"),
])
def test_set_defines_refuses_an_undeclared_macro(kernel, bad):
    before = _build.library_path(kernel)
    with pytest.raises(ValueError, match=bad.split("=")[0]):
        set_defines(kernel, (bad,))
    assert _build.library_path(kernel) == before  # nothing was set
    with pytest.raises(ValueError, match=bad.split("=")[0]):
        _build.build([], variants=[(kernel, (bad,))])


@pytest.mark.parametrize("kernel,good", [
    ("llama_layer", "LAYER_CHUNKS=4"),
    ("llama_layer", "LAYER_NO_MATVEC=1"),
    ("gpt2_layer", "LAYER_CHUNKS=4"),
    ("mlp_fused_q8", "MLP_RW=4"),
    ("matmul_q4_0", "Q4_UNPACK=1"),
])
def test_set_defines_accepts_a_declared_macro(kernel, good):
    base = _build.library_path(kernel)
    try:
        set_defines(kernel, (good,))
        assert _build.library_path(kernel) != base
    finally:
        set_defines(kernel, ())
    assert _build.library_path(kernel) == base


def test_kernel8_probe_calls_its_wrapper_at_one_row(monkeypatch):
    """probe_mlp_q8 with a stand-in chip_smoke and a recording wrapper: every
    variant's call, checked and timed, hands the wrapper MLP_ROWS (1) rows,
    with each variant's defines set while it runs."""
    from ggmlsharp_tpu_torch.kernels import mlp_fused
    from ggmlsharp_tpu_torch.models import gpt2

    gen = torch.Generator().manual_seed(0)
    rows, defines = [], []

    def wrapper(x, w1, b1, w2, b2, mode="f32"):
        rows.append(x.shape[0])
        defines.append(_build._DEFINES.get("mlp_fused_q8", ()))
        return mlp_fused._ff_ref(w1, b1, w2, b2, x, quantize_acts=False)

    def inputs(E, g, dev, copies):
        return [(gpt2.random_q8_0(4 * E, E, g, dev),
                 torch.zeros(4 * E), gpt2.random_q8_0(E, 4 * E, g, dev),
                 torch.zeros(E)) for _ in range(copies)]

    emitted = []
    cs = types.SimpleNamespace(
        gpt2_configs=lambda: [("tiny", gpt2.GPT2_TINY)], L2_BYTES=1 << 16,
        mlp_inputs=inputs, emit=emitted.append,
        time_ms=lambda fn, reps: [fn(i) for i in range(2)] and 0.0)
    monkeypatch.setattr(mlp_fused, "mlp_fused_q8", wrapper)
    PROBE.probe_mlp_q8(cs, torch.device("cpu"), gen)
    assert PROBE.MLP_ROWS == 1
    assert rows and set(rows) == {1}
    assert {tuple(d) for d in defines} == set(PROBE.MLP_VARIANTS.values())
    assert [e["variant"] for e in emitted] == list(PROBE.MLP_VARIANTS)
    assert _build._DEFINES.get("mlp_fused_q8", ()) == ()
