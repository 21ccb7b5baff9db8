"""The port stands alone: no file of ggmlsharp_tpu_torch/ or chip_smoke.py
imports jax or the JAX package, and its entry points refuse to run on the
CPU unless the caller asks for it."""
import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ggmlsharp_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ggmlsharp_tpu")  # not ggmlsharp_tpu_torch


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("ggmlsharp_tpu.ops")
    assert _forbidden("ggmlsharp_tpu")
    assert not _forbidden("ggmlsharp_tpu_torch.ops")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            mods = [str(node.args[0].value)]
        else:
            continue
        bad = [m for m in mods if _forbidden(m)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_default_to_the_card():
    """With no card and no device argument, entry points raise; they never
    carry on on the CPU."""
    from ggmlsharp_tpu_torch import GType, resolve_device
    from ggmlsharp_tpu_torch.models import gpt2, kv_cache, llama
    from ggmlsharp_tpu_torch.quant import from_wire
    from ggmlsharp_tpu_torch.serving import Engine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = llama.TINY_LLAMA
    for call in (lambda: llama.new_cache(cfg, 1),
                 lambda: kv_cache.init_cache(1, 1, 1, 8, 8),
                 lambda: kv_cache.init_cache(1, 1, 1, 8, 128, flat=True,
                                             int8=True),
                 lambda: llama.new_cache(cfg, 1, int8=True),
                 lambda: Engine(llama.forward, cfg, {}, int8_kv=True),
                 lambda: from_wire(GType.Q4_0, bytes(18), (1, 32)),
                 lambda: llama.init_params(cfg),
                 lambda: llama.synthetic_q4_0_params(cfg),
                 lambda: llama.params_from_jax({}),
                 lambda: gpt2.init_params(gpt2.GPT2_TINY),
                 lambda: gpt2.synthetic_q8_0_params(gpt2.GPT2_TINY),
                 lambda: gpt2.new_cache(gpt2.GPT2_TINY, 1),
                 lambda: gpt2.new_cache(gpt2.GPT2_TINY, 4, int8=True),
                 lambda: gpt2.params_from_jax({}),
                 lambda: resolve_device()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert gpt2.new_cache(gpt2.GPT2_TINY, 1, device="cpu").k[0].device.type \
        == "cpu"


def test_import_scan_covers_the_gpt2_slice():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"models/gpt2.py", "kernels/mlp_fused.py", "kernels/gpt2_layer.py",
            "kernels/matmul_q.py", "ops/basic.py"} <= rel


def test_import_scan_covers_the_fused_llama_slice():
    """The whole-block llama module is scanned, and every kernel source of
    the slice is registered in kernels._build and present in csrc/."""
    from ggmlsharp_tpu_torch.kernels import _build

    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"kernels/llama_layer.py", "kernels/mlp_fused.py",
            "kernels/attn_decode.py", "models/llama.py", "config.py"} <= rel
    for name, src in (("mlp_fused_silu_q4", "mlp_fused_silu_q4.cu"),
                      ("llama_layer", "llama_layer.cu"),
                      ("attn_decode", "attn_decode.cu")):
        assert _build.KERNELS[name][0] == src
        assert os.path.isfile(os.path.join(_build.CSRC, src))
        assert name in _build.LAUNCHES
    assert os.path.isfile(os.path.join(_build.CSRC, "q4_dot.cuh"))
    for src in ("mlp_fused_silu_q4.cu", "llama_layer.cu"):
        with open(os.path.join(_build.CSRC, src)) as f:
            text = f.read()
        assert '#include "q4_dot.cuh"' in text
        assert "cublas" not in text.lower() and "torch" not in text.lower()


def test_import_scan_covers_the_speculative_slice():
    """The speculative and GPT-J modules are scanned, and the examples of
    the port (examples/*_torch.py) import no JAX either."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"models/speculative.py", "serving/spec.py", "models/gptj.py",
            "serving/engine.py", "serving/admission.py", "serving/prefix.py",
            "io/gguf.py", "io/hf.py"} <= rel
    ex = os.path.join(ROOT, "examples")
    files = sorted(os.path.join(ex, n) for n in os.listdir(ex)
                   if n.endswith("_torch.py"))
    assert os.path.join(ex, "speculative_torch.py") in files
    for path in files:
        test_port_imports_no_jax(path)


def test_speculative_entry_points_default_to_the_card():
    """GPT-J's entry points and a speculative engine raise without a card
    and without a device argument."""
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.io import load_gguf_gptj, load_hf_gptj
    from ggmlsharp_tpu_torch.models import gptj, llama
    from ggmlsharp_tpu_torch.serving import Engine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = gptj.TINY_GPTJ
    for call in (lambda: gptj.init_params(cfg),
                 lambda: gptj.new_cache(cfg, 1),
                 lambda: gptj.synthetic_params(cfg, GType.Q4_0),
                 lambda: gptj.params_from_jax({}),
                 lambda: load_gguf_gptj("missing.gguf"),
                 lambda: load_hf_gptj("missing.safetensors"),
                 lambda: Engine(llama.forward, llama.TINY_LLAMA, {},
                                draft_forward=llama.forward,
                                draft_params={})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    c = gptj.new_cache(cfg, 1, device="cpu")
    assert c.k[0].device.type == "cpu" and not c.is_flat


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: what a wrapper sees of a
    CUDA tensor before it builds and launches its kernel."""
    is_cuda = property(lambda self: True)


def _fused_llama_calls():
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels import attn_decode, llama_layer, mlp_fused
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.quant import quantize

    cfg = llama.LlamaConfig(n_vocab=256, n_ctx=32, n_embd=256, n_head=4,
                            n_head_kv=4, n_layer=1, n_ff=512)
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen) * 0.1
    blk = {"layer_fused": llama_layer.fuse_llama_layer(
        {"attn_norm": torch.ones(256), "ffn_norm": torch.ones(256),
         "wqkv": r(768, 256), "wo": r(256, 256), "w_gate_up": r(1024, 256),
         "w_down": r(256, 512)}, cfg)}
    card = lambda t: t.as_subclass(_OnCard)
    kv = torch.zeros((8, 256), dtype=torch.bfloat16)
    npast = torch.tensor([3], dtype=torch.int32)
    fused = blk["layer_fused"]
    return {
        "mlp_fused_silu_q4": (mlp_fused, "_ff_silu_ref", lambda: (
            mlp_fused.flash_ff_silu_q4(fused["w_gate_up"], fused["w_down"],
                                       card(r(2, 256))))),
        "llama_layer": (llama_layer, "_layer_ref", lambda: (
            llama_layer.llama_layer_step(blk, card(r(1, 256)), kv, kv, npast,
                                         cfg))),
        "attn_decode": (attn_decode, "_decode_ref", lambda: (
            attn_decode.flash_decode_flat_attn(
                card(r(1, 256)), r(1, 256), r(1, 256), kv[None], kv[None],
                npast, 4, 4, 64))),
    }


@pytest.mark.parametrize("name", ["mlp_fused_silu_q4", "llama_layer",
                                  "attn_decode"])
def test_fused_llama_wrappers_never_fall_back(monkeypatch, name):
    """Given a tensor on the card and no way to build the kernel, a wrapper
    raises: it does not reach its plain version, and it counts no launch."""
    from ggmlsharp_tpu_torch.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("the wrapper fell back to its plain version")

    module, ref, call = _fused_llama_calls()[name]
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(module, ref, plain)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert _build.LAUNCHES == before


def _matmul_calls():
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels import matmul_q, mlp_fused
    from ggmlsharp_tpu_torch.ops import matmul as ops_matmul
    from ggmlsharp_tpu_torch.quant import quantize

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((256, 512), generator=gen)
    x = torch.randn((2, 512), generator=gen).as_subclass(_OnCard)
    qk, q5 = quantize(w, GType.Q4_K), quantize(w, GType.Q5_1)
    q40 = quantize(w, GType.Q4_0)
    w1, w2 = quantize(w, GType.Q8_0), quantize(w.T.contiguous(), GType.Q8_0)
    b1, b2 = torch.zeros(256), torch.zeros(512)
    gelu_mlp = lambda xs: mlp_fused.flash_ff_q8(w1, b1, w2, b2, xs)
    fused = matmul_q.mul_mat_q_fused
    return {
        "matmul_q": (ops_matmul, "mul_mat_q", lambda: fused(qk, x[:1])),
        "matmul_q_mma": (ops_matmul, "mul_mat_q", lambda: fused(qk, x)),
        "matmul_q4_0": (ops_matmul, "mul_mat_q", lambda: fused(
            q40, x[:1], quantize_acts=False)),
        "matmul_q4_0_mma": (ops_matmul, "mul_mat_q", lambda: fused(q40, x)),
        "matmul_int_dot": (matmul_q, "_int_dot_ref",
                           lambda: matmul_q.mul_mat_q_fused(q5, x[:1])),
        "mlp_fused_q8": (mlp_fused, "_ff_ref", lambda: gelu_mlp(x[:1])),
        "mlp_fused_q8_mma": (mlp_fused, "_ff_ref", lambda: gelu_mlp(x)),
    }


@pytest.mark.parametrize("name", ["matmul_q", "matmul_int_dot",
                                  "matmul_q_mma", "matmul_q4_0",
                                  "matmul_q4_0_mma", "mlp_fused_q8",
                                  "mlp_fused_q8_mma"])
def test_matmul_wrappers_never_fall_back(monkeypatch, name):
    """Kernel A (Q4_K here), the Q4_0 kernel and the fused GELU MLP (Q8_0),
    each instance (one row: the b = 1 instance; two: the multi-row one,
    counted as ``<kernel>_mma``), and kernel B (Q5_1, GGML_TPU_INT_DOT=1)
    on a tensor on the card with no
    way to build the kernel: the wrapper raises, reaches no plain version
    and counts no launch. Every instance has its counter; the sources are
    registered and free of PyTorch's headers."""
    from ggmlsharp_tpu_torch.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("the wrapper fell back to its plain version")

    src = _build.KERNELS[name][0]
    with open(os.path.join(_build.CSRC, src)) as f:
        text = f.read()
    includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
    assert includes and not any("torch" in ln or "ATen" in ln
                                for ln in includes)
    assert name in _build.LAUNCHES
    module, ref, call = _matmul_calls()[name]
    monkeypatch.setenv("GGML_TPU_INT_DOT", "1")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(module, ref, plain)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert _build.LAUNCHES == before


def test_import_scan_covers_the_formats_slice():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"quant/registry.py", "quant/quantize.py", "quant/formats.py",
            "kernels/matmul_q.py", "ops/matmul.py"} <= rel


def test_format_entry_points_default_to_the_card():
    """synthetic_params and from_wire in the new formats follow the device
    rule: without a card and without device="cpu" they raise."""
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.quant import from_wire

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = llama.LlamaConfig(n_vocab=256, n_ctx=32, n_embd=256, n_head=4,
                            n_head_kv=4, n_layer=1, n_ff=512)
    for call in (lambda: llama.synthetic_params(cfg, GType.Q4_K),
                 lambda: from_wire(GType.Q6_K, bytes(210), (1, 256))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    p = llama.synthetic_params(cfg, GType.Q4_K, device="cpu")
    assert p["blocks"][0]["wo"]["qs"].device.type == "cpu"


def test_import_scan_covers_the_training_slice():
    """The graph, optimizer and tooling layers and the ggml API are scanned;
    the flash source keeps PyTorch's headers out and both of its entries
    have a launch counter."""
    from ggmlsharp_tpu_torch.kernels import _build

    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"graph/core.py", "graph/builders.py", "graph/op_defs.py",
            "optim/adam.py", "optim/lbfgs.py", "optim/facade.py",
            "optim/params.py", "utils/debug.py", "utils/graphviz.py",
            "compat.py", "ops/attention.py", "ops/basic.py", "ops/conv.py",
            "kernels/flash.py"} <= rel
    with open(os.path.join(_build.CSRC, "flash_attn.cu")) as f:
        text = f.read()
    assert "torch" not in text.lower()
    assert {"flash_attn", "flash_attn_uncached"} <= set(_build.LAUNCHES)


def test_training_entry_points_default_to_the_card():
    """leaf() of host data and ggml_init() follow the device rule: without a
    card and without device="cpu" they raise."""
    import numpy as np

    from ggmlsharp_tpu_torch import compat
    from ggmlsharp_tpu_torch.graph import leaf

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for call in (lambda: leaf(np.zeros(3, np.float32)),
                 lambda: leaf([1.0, 2.0]),
                 lambda: compat.ggml_init()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert leaf(np.zeros(3), device="cpu").data.device.type == "cpu"
    assert compat.ggml_init(device="cpu").device.type == "cpu"
    # a tensor stays where it is
    assert leaf(torch.zeros(2)).data.device.type == "cpu"


def _flash_calls():
    from ggmlsharp_tpu_torch import ops
    from ggmlsharp_tpu_torch.kernels import flash

    gen = torch.Generator().manual_seed(0)
    card = lambda *s: torch.randn(s, generator=gen).as_subclass(_OnCard)
    r = lambda *s: torch.randn(s, generator=gen)
    npast = torch.tensor([2], dtype=torch.int32)
    return {
        "cached": ("_cached_ref", lambda: flash.flash_attention_cached(
            card(1, 2, 4, 32), r(1, 2, 8, 32), r(1, 2, 8, 32), npast)),
        "uncached": ("_uncached_ref", lambda: flash.flash_attention(
            card(2, 4, 32), r(2, 6, 32), r(2, 6, 32), causal=False)),
        "graph_op": ("_uncached_ref", lambda: ops.flash_attn(
            card(2, 4, 8), r(2, 4, 8), r(2, 4, 8))),
    }


@pytest.mark.parametrize("entry", ["cached", "uncached", "graph_op"])
def test_flash_wrappers_never_fall_back(monkeypatch, entry):
    """Both flash entries, and the graph op, on a tensor on the card with no
    way to build the kernel: they raise, reach neither plain version and
    count no launch."""
    from ggmlsharp_tpu_torch.kernels import _build, flash
    from ggmlsharp_tpu_torch.ops import attention

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("the wrapper fell back to its plain version")

    ref, call = _flash_calls()[entry]
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(flash, ref, plain)
    monkeypatch.setattr(attention, "_flash_dense", plain)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert _build.LAUNCHES == before


def test_import_scan_covers_the_tuning_slice():
    """The config layer, the tune table, the autotuner and the probes are
    scanned; each new source is registered, free of PyTorch's headers, and
    each of its entries has a launch counter."""
    from ggmlsharp_tpu_torch.kernels import _build

    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"config.py", "kernels/config.py", "kernels/tune.py",
            "kernels/autotune.py", "probes/common.py",
            "probes/dq_variants.py", "probes/swar.py",
            "probes/scale_decode.py", "models/common.py"} <= rel
    for name, src in (("matmul_q4_0_kmajor", "matmul_q4_0_kmajor.cu"),
                      ("probe_copy", "probes.cu"),
                      ("probe_byte_order", "probes.cu"),
                      ("probe_f16_decode", "probes.cu"),
                      ("probe_block_map", "probes.cu")):
        assert _build.KERNELS[name][0] == src and name in _build.LAUNCHES
        with open(os.path.join(_build.CSRC, src)) as f:
            includes = [ln for ln in f.read().splitlines()
                        if ln.startswith("#include")]
        assert includes and not any("torch" in ln or "ATen" in ln
                                    or "cublas" in ln for ln in includes)
    assert {"matmul_q4_0_i2f", "matmul_q4_0_half2"} <= set(_build.LAUNCHES)


def test_tuning_entry_points_default_to_the_card():
    """The probes and the autotuner (python -m ...) refuse to run without a
    card unless asked for the CPU."""
    from ggmlsharp_tpu_torch.kernels import autotune
    from ggmlsharp_tpu_torch.probes import dq_variants, scale_decode, swar

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for main in (dq_variants.main, swar.main, scale_decode.main,
                 autotune.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--device", "cuda"])
    assert swar.main(["--device", "cpu"]) == 0


def _probe_calls():
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.models.llama import random_q4_0
    from ggmlsharp_tpu_torch.probes import dq_variants, scale_decode, swar

    card = lambda t: t.as_subclass(_OnCard)
    w = random_q4_0(64, 256, torch.Generator().manual_seed(0), "cpu")
    P, d = swar.kmajor_repack(w)
    return {
        "matmul_q4_0_kmajor": (swar, "kmajor_matmul_ref", lambda: (
            swar.kmajor_matmul(card(torch.randn(1, 256)), P, d))),
        "probe_copy": (torch.Tensor, None, lambda: dq_variants.copy_plane(
            card(torch.zeros(64, dtype=torch.int32)))),
        "probe_byte_order": (swar, "byte_order_ref", lambda: swar.byte_order(
            card(torch.arange(16, dtype=torch.uint8)))),
        "probe_f16_decode": (scale_decode, "f16_decode_ref",
                             lambda: scale_decode.f16_decode(
                                 card(torch.zeros(8, dtype=torch.float16)))),
        "probe_block_map": (scale_decode, "block_map_ref",
                            lambda: scale_decode.block_map(
                                GType.Q4_0, card(torch.ones(2)), 64)),
    }


@pytest.mark.parametrize("name", ["matmul_q4_0_kmajor", "probe_copy",
                                  "probe_byte_order", "probe_f16_decode",
                                  "probe_block_map"])
def test_probe_wrappers_never_fall_back(monkeypatch, name):
    """Each probe kernel's wrapper, given a tensor on the card and no way to
    build the kernel, raises: it reaches no plain version and counts no
    launch."""
    from ggmlsharp_tpu_torch.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("the wrapper fell back to its plain version")

    module, ref, call = _probe_calls()[name]
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    if ref is not None:
        monkeypatch.setattr(module, ref, plain)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert _build.LAUNCHES == before


def _c_params(src: str, sym: str) -> list[str]:
    """The parameter list of ``extern "C" int sym(...)`` in csrc/src."""
    from ggmlsharp_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC, src)) as f:
        text = f.read()
    head = f'extern "C" int {sym}('
    start = text.index(head) + len(head)
    return [p.strip() for p in text[start:text.index(")", start)].split(",")]


@pytest.mark.parametrize("name", sorted(
    __import__("ggmlsharp_tpu_torch.kernels._build",
               fromlist=["KERNELS"]).KERNELS))
def test_entry_argtypes_match_the_c_signatures(name):
    """Each C entry's ctypes argtypes list one type a parameter, in the
    source's order: pointers (and the stream) as c_void_p, 64-bit integers
    as c_longlong, floats as c_float, ints as c_int. A missing entry would
    let ctypes pass the stream as a 32-bit int."""
    import ctypes

    from ggmlsharp_tpu_torch.kernels import _build

    src, sym, argtypes = _build.KERNELS[name]
    params = _c_params(src, sym)
    assert len(params) == len(argtypes), (params, argtypes)

    def kind(p):
        if "*" in p or p.startswith("cudaStream_t"):
            return ctypes.c_void_p
        if p.startswith("long long"):
            return ctypes.c_longlong
        if p.startswith("float"):
            return ctypes.c_float
        return ctypes.c_int

    assert [kind(p) for p in params] == list(argtypes), params
