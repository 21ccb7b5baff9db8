"""HuggingFace safetensors import -> model parameter trees (port of
ggmlsharp_tpu/io/hf.py: GPT-2, Llama and GPT-J).

The safetensors format is read here without the ``safetensors`` package: an
8-byte little-endian header length, a JSON header ({name: {dtype, shape,
data_offsets}}, ``__metadata__``), then each tensor's raw little-endian
bytes. F32, F16 and BF16 (and the integer types) become torch tensors
directly; numpy, which has no bf16, only carries the bytes. HF checkpoints
hold float weights: quantize them with the model's ``quantize_params``.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..device import resolve_device

# safetensors dtype -> (numpy dtype of the same width, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def read_safetensors(path: str, device=None) -> dict:
    """One .safetensors file -> {name: tensor on ``device``} (the card unless
    the caller asks for another), values bit for bit as stored."""
    dev = resolve_device(device)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which this reader does not know")
        npdt, tdt = _DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(data[base + lo:base + hi], npdt).copy()
        t = torch.from_numpy(arr)
        if t.dtype != tdt:  # bf16: the bits ride an int16 array
            t = t.view(tdt)
        out[name] = t.reshape(info["shape"]).to(dev)
    return out


def _load_safetensors(path: str, device) -> dict:
    """A file, or a directory of shards (every .safetensors in it)."""
    files = [path]
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
    out = {}
    for f in files:
        out.update(read_safetensors(f, device))
    return out


def _config(path: str, config: dict | None) -> dict:
    if config is None and os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
    return config or {}


def load_hf_gpt2(path: str, config: dict | None = None, device=None):
    """path: a .safetensors file or a directory (with config.json). Returns
    (GPT2Config, params) on ``device``. HF's Conv1D stores weights
    transposed ([in, out]) against the port's [out, in] linears; they are
    transposed here."""
    from ..models.gpt2 import GPT2Config

    t = _load_safetensors(path, device)
    config = _config(path, config)

    def g(name):
        for k in (name, "transformer." + name):
            if k in t:
                return t[k]
        raise KeyError(name)

    def lin(name):
        return g(name).t().contiguous()

    n_layer = config.get("n_layer") or max(
        int(k.split(".")[1 + k.startswith("transformer.")]) for k in t
        if ".h." in k or k.startswith("h.")) + 1
    wte = g("wte.weight")
    cfg = GPT2Config(
        n_vocab=wte.shape[0],
        n_ctx=config.get("n_positions", g("wpe.weight").shape[0]),
        n_embd=wte.shape[1],
        n_head=config.get("n_head", 12),
        n_layer=n_layer,
    )
    params = {
        "wte": wte,
        "wpe": g("wpe.weight"),
        "ln_f": {"g": g("ln_f.weight"), "b": g("ln_f.bias")},
        "blocks": [],
    }
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        params["blocks"].append({
            "ln_1": {"g": g(p + "ln_1.weight"), "b": g(p + "ln_1.bias")},
            "attn": {"c_attn_w": lin(p + "attn.c_attn.weight"),
                     "c_attn_b": g(p + "attn.c_attn.bias"),
                     "c_proj_w": lin(p + "attn.c_proj.weight"),
                     "c_proj_b": g(p + "attn.c_proj.bias")},
            "ln_2": {"g": g(p + "ln_2.weight"), "b": g(p + "ln_2.bias")},
            "mlp": {"c_fc_w": lin(p + "mlp.c_fc.weight"),
                    "c_fc_b": g(p + "mlp.c_fc.bias"),
                    "c_proj_w": lin(p + "mlp.c_proj.weight"),
                    "c_proj_b": g(p + "mlp.c_proj.bias")},
        })
    return cfg, params


def load_hf_llama(path: str, config: dict | None = None, device=None):
    """LlamaForCausalLM safetensors -> (LlamaConfig, params) on ``device``.

    HF Llama checkpoints lay the q/k head dims out for half-split (NeoX)
    rotary. No weight is permuted: the config sets rope_mode=2, so the model
    applies the matching half-split rope (llama.cpp's converter permutes the
    weights instead and uses interleaved rope; the logits are the same)."""
    from ..models.llama import LlamaConfig

    t = _load_safetensors(path, device)
    config = _config(path, config)

    def g(name):
        for k in (name, "model." + name):
            if k in t:
                return t[k]
        raise KeyError(name)

    emb = g("embed_tokens.weight")
    n_layer = config.get("num_hidden_layers") or max(
        int(k.split("layers.")[1].split(".")[0]) for k in t
        if "layers." in k) + 1
    n_head = config.get("num_attention_heads", 32)
    cfg = LlamaConfig(
        n_vocab=emb.shape[0],
        n_ctx=config.get("max_position_embeddings", 2048),
        n_embd=emb.shape[1],
        n_head=n_head,
        n_head_kv=config.get("num_key_value_heads", n_head),
        n_layer=n_layer,
        n_ff=config.get("intermediate_size", 11008),
        rms_eps=config.get("rms_norm_eps", 1e-6),
        rope_base=config.get("rope_theta", 10000.0),
        rope_mode=2,  # HF pairs (i, i + half): NeoX-style halves
        tie_lm_head="lm_head.weight" not in t,
    )
    params = {
        "tok_embd": emb,
        "norm": g("norm.weight"),
        "output": t.get("lm_head.weight"),
        "blocks": [],
    }
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        params["blocks"].append({
            "attn_norm": g(p + "input_layernorm.weight"),
            "wq": g(p + "self_attn.q_proj.weight"),
            "wk": g(p + "self_attn.k_proj.weight"),
            "wv": g(p + "self_attn.v_proj.weight"),
            "wo": g(p + "self_attn.o_proj.weight"),
            "ffn_norm": g(p + "post_attention_layernorm.weight"),
            "w_gate": g(p + "mlp.gate_proj.weight"),
            "w_up": g(p + "mlp.up_proj.weight"),
            "w_down": g(p + "mlp.down_proj.weight"),
        })
    return cfg, params


def load_hf_gptj(path: str, config: dict | None = None, device=None):
    """GPTJForCausalLM safetensors -> (GPTJConfig, params) on ``device``. HF
    GPT-J's rotate_every_two rotary (interleaved pairs over rotary_dim dims)
    is models.gptj's mode-0 partial rope, so the weights map one to one. No
    lm_head: the embedding is the head, with a zero bias of its dtype."""
    from ..models.gptj import GPTJConfig

    t = _load_safetensors(path, device)
    config = _config(path, config)

    def g(name):
        for k in (name, "transformer." + name):
            if k in t:
                return t[k]
        raise KeyError(name)

    emb = g("wte.weight")
    n_layer = config.get("n_layer") or max(
        int(k.split("h.")[1].split(".")[0]) for k in t
        if ".h." in k or k.startswith("h.")) + 1
    cfg = GPTJConfig(
        n_vocab=emb.shape[0],
        n_ctx=config.get("n_positions", 2048),
        n_embd=emb.shape[1],
        n_head=config.get("n_head", 16),
        n_layer=n_layer,
        rotary_dim=config.get("rotary_dim", 64),
        ln_eps=config.get("layer_norm_epsilon", 1e-5),
    )
    params = {
        "wte": emb,
        "ln_f": {"g": g("ln_f.weight"), "b": g("ln_f.bias")},
        "lm_head": {
            "w": t.get("lm_head.weight", emb),
            "b": t.get("lm_head.bias",
                       torch.zeros(emb.shape[0], dtype=emb.dtype,
                                   device=emb.device)),
        },
        "blocks": [],
    }
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        params["blocks"].append({
            "ln_1": {"g": g(p + "ln_1.weight"), "b": g(p + "ln_1.bias")},
            "attn": {"wq": g(p + "attn.q_proj.weight"),
                     "wk": g(p + "attn.k_proj.weight"),
                     "wv": g(p + "attn.v_proj.weight"),
                     "wo": g(p + "attn.out_proj.weight")},
            "mlp": {"fc_in_w": g(p + "mlp.fc_in.weight"),
                    "fc_in_b": g(p + "mlp.fc_in.bias"),
                    "fc_out_w": g(p + "mlp.fc_out.weight"),
                    "fc_out_b": g(p + "mlp.fc_out.bias")},
        })
    return cfg, params
