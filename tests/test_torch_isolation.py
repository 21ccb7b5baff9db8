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
