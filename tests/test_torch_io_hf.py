"""The port's safetensors reader and HF loaders against the JAX package's,
on the CPU. Files are written here with the ``safetensors`` package, in F32,
F16 and BF16, as one file and as two shards beside a config.json; the port
reads them without that package. Every array must be equal bit for bit to
JAX's ``load_hf_gpt2`` / ``load_hf_llama`` (bf16 compared as its bits), and
the configs equal, Llama's rope_mode=2 included."""
import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from ggmlsharp_tpu.io import hf as jhf
from ggmlsharp_tpu_torch.io import hf

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ggmlsharp_tpu_torch")
DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
GPT2 = dict(n_layer=2, n_embd=64, n_head=4, n_vocab=96, n_ctx=32)
LLAMA = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=128, vocab_size=96,
             max_position_embeddings=64, rms_norm_eps=1e-5,
             rope_theta=500000.0)


def _gpt2_tensors(dtype, prefix=""):
    g = torch.Generator().manual_seed(0)
    E, V, T = GPT2["n_embd"], GPT2["n_vocab"], GPT2["n_ctx"]

    def r(*s):
        return (torch.randn(s, generator=g) * 0.1).to(dtype)

    t = {"wte.weight": r(V, E), "wpe.weight": r(T, E),
         "ln_f.weight": r(E), "ln_f.bias": r(E)}
    for i in range(GPT2["n_layer"]):
        p = f"h.{i}."
        t.update({p + "ln_1.weight": r(E), p + "ln_1.bias": r(E),
                  p + "attn.c_attn.weight": r(E, 3 * E),  # Conv1D: [in, out]
                  p + "attn.c_attn.bias": r(3 * E),
                  p + "attn.c_proj.weight": r(E, E),
                  p + "attn.c_proj.bias": r(E),
                  p + "ln_2.weight": r(E), p + "ln_2.bias": r(E),
                  p + "mlp.c_fc.weight": r(E, 4 * E),
                  p + "mlp.c_fc.bias": r(4 * E),
                  p + "mlp.c_proj.weight": r(4 * E, E),
                  p + "mlp.c_proj.bias": r(E)})
    return {prefix + k: v for k, v in t.items()}


def _llama_tensors(dtype, tied=False):
    g = torch.Generator().manual_seed(1)
    c = LLAMA
    E, F, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = E // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * hd

    def r(*s):
        return (torch.randn(s, generator=g) * 0.1).to(dtype)

    t = {"model.embed_tokens.weight": r(V, E), "model.norm.weight": r(E)}
    if not tied:
        t["lm_head.weight"] = r(V, E)
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": r(E),
                  p + "self_attn.q_proj.weight": r(E, E),
                  p + "self_attn.k_proj.weight": r(kv, E),
                  p + "self_attn.v_proj.weight": r(kv, E),
                  p + "self_attn.o_proj.weight": r(E, E),
                  p + "post_attention_layernorm.weight": r(E),
                  p + "mlp.gate_proj.weight": r(F, E),
                  p + "mlp.up_proj.weight": r(F, E),
                  p + "mlp.down_proj.weight": r(E, F)})
    return t


def _write(tmp_path, tensors, layout, config):
    """One file (config passed to the loader) or two shards + config.json
    (the loader reads the directory)."""
    if layout == "file":
        path = str(tmp_path / "model.safetensors")
        save_file(tensors, path)
        return path, config
    names = sorted(tensors)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        save_file({k: tensors[k] for k in part},
                  str(tmp_path / f"model-{i + 1:05d}-of-00002.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config, f)
    return str(tmp_path), None


def _bits(x):
    """A leaf's bits and dtype name, torch or numpy (bf16 as int16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16), "bfloat16"
    return x, str(x.dtype)


def _assert_trees_equal(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _assert_trees_equal(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_trees_equal(a, b, f"{path}/{i}")
    elif j is None:
        assert t is None, path
    else:
        (tb, tdt), (jb, jdt) = _bits(t), _bits(j)
        assert tdt == jdt, (path, tdt, jdt)
        assert tb.shape == jb.shape, path
        np.testing.assert_array_equal(tb, jb, err_msg=path)


@pytest.mark.parametrize("layout", ["file", "shards"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gpt2_matches_jax(tmp_path, dt, layout):
    config = {"n_layer": GPT2["n_layer"], "n_head": GPT2["n_head"],
              "n_positions": GPT2["n_ctx"]}
    prefix = "transformer." if layout == "shards" else ""
    path, cfg_arg = _write(tmp_path, _gpt2_tensors(DTYPES[dt], prefix),
                           layout, config)
    jcfg, jp = jhf.load_hf_gpt2(path, config=cfg_arg)
    tcfg, tp = hf.load_hf_gpt2(path, config=cfg_arg, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(tp, jp)
    w = tp["blocks"][1]["mlp"]["c_fc_w"]
    assert w.shape == (4 * GPT2["n_embd"], GPT2["n_embd"]) \
        and w.is_contiguous()


@pytest.mark.parametrize("layout", ["file", "shards"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_llama_matches_jax(tmp_path, dt, layout):
    path, cfg_arg = _write(tmp_path, _llama_tensors(DTYPES[dt]), layout,
                           LLAMA)
    jcfg, jp = jhf.load_hf_llama(path, config=cfg_arg)
    tcfg, tp = hf.load_hf_llama(path, config=cfg_arg, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.rope_mode == 2 and tcfg.n_head_kv == 2 \
        and tcfg.rope_base == 500000.0 and not tcfg.tie_lm_head
    _assert_trees_equal(tp, jp)


def test_llama_tied_head_and_inferred_depth(tmp_path):
    """No lm_head: tie_lm_head and output None; no config: the depth comes
    from the tensor names, the rest from the defaults, as in JAX."""
    path, _ = _write(tmp_path, _llama_tensors(torch.float32, tied=True),
                     "file", None)
    jcfg, jp = jhf.load_hf_llama(path)
    tcfg, tp = hf.load_hf_llama(path, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.tie_lm_head and tp["output"] is None and tcfg.n_layer == 2
    _assert_trees_equal(tp, jp)


def test_read_safetensors_every_dtype(tmp_path):
    """The reader against the safetensors package's own, dtype by dtype."""
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(2)
    t = {"f64": torch.randn(3, 2, generator=g, dtype=torch.float64),
         "f32": torch.randn(5, generator=g), "bf16": torch.randn(
             2, 3, generator=g).to(torch.bfloat16),
         "f16": torch.randn(4, generator=g).half(),
         "i64": torch.arange(6).reshape(2, 3), "i32": torch.arange(3,
                                                                   dtype=torch.int32),
         "i8": torch.tensor([-3, 5], dtype=torch.int8),
         "u8": torch.tensor([200, 1], dtype=torch.uint8),
         "b": torch.tensor([True, False]), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(t, path, metadata={"format": "pt"})
    got, want = hf.read_safetensors(path, device="cpu"), load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_reader_imports_no_safetensors(tmp_path, monkeypatch):
    """The card's machine has no safetensors package: no module of the port
    imports it, and the loaders work with its import blocked."""
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            with open(os.path.join(dirpath, n)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module or ""] if isinstance(
                    node, ast.ImportFrom) else []
                assert not any(m.split(".")[0] == "safetensors"
                               for m in mods), (n, mods)
    path, cfg_arg = _write(tmp_path, _gpt2_tensors(torch.bfloat16), "file",
                           {"n_layer": 2, "n_head": 4})
    monkeypatch.setitem(sys.modules, "safetensors", None)
    cfg, p = hf.load_hf_gpt2(path, config=cfg_arg, device="cpu")
    assert cfg.n_layer == 2 and p["wte"].dtype == torch.bfloat16


def test_loaders_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    path, cfg_arg = _write(tmp_path, _llama_tensors(torch.float16), "file",
                           LLAMA)
    for call in (lambda: hf.load_hf_llama(path, config=cfg_arg),
                 lambda: hf.read_safetensors(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
