"""GGUF reader and writer, and the llama.cpp name mappings for Llama and
GPT-J (port of ggmlsharp_tpu/io/gguf.py).

GGUF is llama.cpp's model container (magic ``GGUF``, little-endian, v2/v3):
a header of typed key/value metadata and tensor infos, then each tensor's
ggml wire blocks at an aligned offset. The port's QTensor planes are the wire
fields themselves (``quant.formats``), so reading and writing only move
bytes: ``from_wire`` on load, ``to_wire`` on save. The JAX package's
wire <-> TPU planar conversion has no counterpart here.

``GGUFWriter`` streams: it works out every tensor's offset from its wire
size, writes the header, then each tensor's bytes in turn, so no more than
one tensor's bytes are held on the host at a time. Its file is byte for byte
the JAX writer's for the same metadata and tensors.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import GType
from ..quant.formats import QTensor, from_wire, to_wire, wire_block_bytes

MAGIC = b"GGUF"

# GGUF value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, \
    _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)
_SCALAR = {_T_U8: "B", _T_I8: "b", _T_U16: "H", _T_I16: "h", _T_U32: "I",
           _T_I32: "i", _T_F32: "f", _T_U64: "Q", _T_I64: "q", _T_F64: "d"}

# GGML wire dtype ids (ggml.h enum, modern numbering). Q4_2 and Q4_3 have
# none: the writer refuses them.
GGML_WIRE = {
    0: GType.F32, 1: GType.F16, 2: GType.Q4_0, 3: GType.Q4_1,
    6: GType.Q5_0, 7: GType.Q5_1, 8: GType.Q8_0, 9: GType.Q8_1,
    12: GType.Q4_K, 14: GType.Q6_K, 15: GType.Q8_K,
}
WIRE_ID = {v: k for k, v in GGML_WIRE.items()}
_FLOAT = {GType.F32: (np.float32, torch.float32),
          GType.F16: (np.float16, torch.float16)}


def wire_nbytes(gtype: GType, shape) -> int:
    """Bytes of a ``shape`` tensor of ``gtype`` on the wire."""
    n = int(np.prod(shape))
    if gtype in _FLOAT:
        return n * np.dtype(_FLOAT[gtype][0]).itemsize
    bs, bb = wire_block_bytes(gtype)
    return n // bs * bb


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple  # row-major, last axis = ggml ne[0]
    gtype: GType
    offset: int   # absolute, in the file
    nbytes: int


class GGUFReader:
    """GGUF v2/v3 reader. The file is memory-mapped: parsing the header
    touches only its pages, and a tensor's load reads only its own bytes."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: dict = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._data = np.memmap(path, dtype=np.uint8, mode="r")
        self._parse(memoryview(self._data))

    def _parse(self, mv):
        off = 0

        def u(fmt):
            nonlocal off
            (v,) = struct.unpack_from("<" + fmt, mv, off)
            off += struct.calcsize(fmt)
            return v

        def rd_str():
            nonlocal off
            n = u("Q")
            s = bytes(mv[off:off + n]).decode("utf-8")
            off += n
            return s

        def rd_val(t):
            if t in _SCALAR:
                return u(_SCALAR[t])
            if t == _T_BOOL:
                return bool(u("B"))
            if t == _T_STR:
                return rd_str()
            if t == _T_ARR:
                et = u("I")
                return [rd_val(et) for _ in range(u("Q"))]
            raise ValueError(f"unknown GGUF value type {t}")

        if bytes(mv[:4]) != MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        off = 4
        version = u("I")
        if version not in (2, 3):
            raise ValueError(f"{self.path}: GGUF version {version}")
        n_tensors, n_kv = u("Q"), u("Q")
        for _ in range(n_kv):
            key = rd_str()
            self.metadata[key] = rd_val(u("I"))
        infos = []
        for _ in range(n_tensors):
            name = rd_str()
            dims = [u("Q") for _ in range(u("I"))]  # ne[] order, ne0 first
            wire_t = u("I")
            if wire_t not in GGML_WIRE:
                raise ValueError(f"{name}: unsupported ggml type id {wire_t}")
            infos.append((name, tuple(reversed(dims)), GGML_WIRE[wire_t],
                          u("Q")))
        align = self.metadata.get("general.alignment", 32)
        data_start = (off + align - 1) // align * align
        for name, shape, g, toff in infos:
            self.tensors[name] = GGUFTensorInfo(
                name, shape, g, data_start + toff, wire_nbytes(g, shape))

    def raw(self, name: str) -> np.ndarray:
        """The tensor's wire bytes: a uint8 view of the mapped file."""
        ti = self.tensors[name]
        return self._data[ti.offset:ti.offset + ti.nbytes]

    def load(self, name: str, device=None):
        """A QTensor for a block format, a float32 / float16 tensor for
        F32 / F16, on ``device`` (the card unless the caller asks for
        another)."""
        ti = self.tensors[name]
        return qtensor_from_wire(ti.gtype, self.raw(name), ti.shape, device)


def qtensor_from_wire(gtype, raw, shape, device=None):
    """ggml wire bytes -> a QTensor (block formats) or a float32 / float16
    tensor (F32 / F16) on ``device`` (the card unless the caller asks for
    another)."""
    gtype = GType(gtype)
    if gtype in _FLOAT:
        npdt, _ = _FLOAT[gtype]
        arr = np.frombuffer(raw, npdt).reshape(tuple(shape))
        return torch.from_numpy(arr.copy()).to(resolve_device(device))
    return from_wire(gtype, raw, shape, device)


def qtensor_to_wire(t) -> tuple:
    """A QTensor or a float32 / float16 tensor or array -> (gtype, ggml wire
    bytes)."""
    g, _, wire = _wire_of(t)
    return g, wire()


def _wire_of(t):
    """(gtype, shape, a function giving the wire bytes) of a QTensor or a
    float32 / float16 tensor or array. The bytes are made when the writer
    reaches the tensor."""
    if isinstance(t, QTensor):
        if t.gtype not in WIRE_ID:
            raise ValueError(f"{t.gtype.name} has no GGUF type id; GGUF "
                             "cannot hold it")
        return t.gtype, t.shape, lambda: to_wire(t)
    if isinstance(t, torch.Tensor):
        t = t.detach()
        for g, (_, tdt) in _FLOAT.items():
            if t.dtype == tdt:
                return g, tuple(t.shape), \
                    lambda: t.contiguous().cpu().numpy().tobytes()
        raise ValueError(f"GGUF float tensors are float32 or float16, not "
                         f"{t.dtype}")
    arr = np.asarray(t)
    for g, (npdt, _) in _FLOAT.items():
        if arr.dtype == npdt:
            return g, arr.shape, lambda: np.ascontiguousarray(arr).tobytes()
    raise ValueError(f"GGUF float tensors are float32 or float16, not "
                     f"{arr.dtype}")


class GGUFWriter:
    """GGUF v3 writer. ``add_meta(key, vtype, value)`` (an array's value is
    ``(element type, items)``), ``add_tensor(name, t)``, then ``write``."""

    def __init__(self):
        self.metadata: list[tuple[str, int, object]] = []
        self.tensors: list[tuple[str, GType, tuple, object]] = []

    def add_meta(self, key: str, vtype: int, value):
        self.metadata.append((key, vtype, value))

    def add_tensor(self, name: str, t):
        g, shape, wire = _wire_of(t)
        self.tensors.append((name, g, tuple(int(s) for s in shape), wire))

    def _header(self, align: int) -> bytes:
        out = bytearray()

        def w_str(s):
            b = s.encode("utf-8")
            out.extend(struct.pack("<Q", len(b)))
            out.extend(b)

        def w_val(t, v):
            if t == _T_BOOL:
                out.extend(struct.pack("<B", int(v)))
            elif t == _T_STR:
                w_str(v)
            elif t == _T_ARR:
                et, items = v
                out.extend(struct.pack("<IQ", et, len(items)))
                for it in items:
                    w_val(et, it)
            elif t in _SCALAR:
                out.extend(struct.pack("<" + _SCALAR[t], v))
            else:
                raise ValueError(f"unknown GGUF value type {t}")

        out += MAGIC
        out += struct.pack("<IQQ", 3, len(self.tensors),
                           len(self.metadata) + 1)
        w_str("general.alignment")
        out.extend(struct.pack("<II", _T_U32, align))
        for key, t, v in self.metadata:
            w_str(key)
            out.extend(struct.pack("<I", t))
            w_val(t, v)
        offset = 0
        for name, g, shape, _ in self.tensors:
            w_str(name)
            dims = tuple(reversed(shape))
            out.extend(struct.pack("<I", len(dims)))
            for d in dims:
                out.extend(struct.pack("<Q", d))
            out.extend(struct.pack("<IQ", WIRE_ID[g], offset))
            n = wire_nbytes(g, shape)
            offset += n + (-n) % align
        out += b"\0" * ((-len(out)) % align)
        return bytes(out)

    def write(self, path: str, align: int = 32) -> dict:
        """Write the file, one tensor's bytes at a time. Returns each
        tensor's sha256 digest of the wire bytes written."""
        digests = {}
        with open(path, "wb") as f:
            f.write(self._header(align))
            for name, g, shape, wire in self.tensors:
                raw = wire()
                if len(raw) != wire_nbytes(g, shape):
                    raise ValueError(f"{name}: {len(raw)} wire bytes, "
                                     f"{wire_nbytes(g, shape)} expected")
                digests[name] = hashlib.sha256(raw).hexdigest()
                f.write(raw)
                f.write(b"\0" * ((-len(raw)) % align))
                del raw
        return digests


# --- llama.cpp name mapping ----------------------------------------------

_BLOCK_NAMES = [("attn_norm", "attn_norm"), ("attn_q", "wq"),
                ("attn_k", "wk"), ("attn_v", "wv"), ("attn_output", "wo"),
                ("ffn_norm", "ffn_norm"), ("ffn_gate", "w_gate"),
                ("ffn_up", "w_up"), ("ffn_down", "w_down")]


def load_gguf_llama(path: str, device=None):
    """A llama.cpp GGUF -> (LlamaConfig, parameter tree) on ``device`` (the
    card unless the caller asks for another). The tree is the unfused one,
    as the JAX package gives it (``wq``, ``wk``, ``wv``, ``w_gate``,
    ``w_up``; no vocabulary padding): ``llama.forward`` takes it as it is,
    and ``llama.fuse_params`` makes the fused layout. Tensors keep the
    file's types (llama.cpp writes the norms as F32)."""
    from ..models.llama import LlamaConfig

    dev = resolve_device(device)
    r = GGUFReader(path)
    md = r.metadata
    arch = md.get("general.architecture", "llama")

    def g(k, d=None):
        return md.get(f"{arch}.{k}", d)

    n_layer = g("block_count")
    cfg = LlamaConfig(
        n_vocab=r.tensors["token_embd.weight"].shape[0],
        n_ctx=g("context_length", 2048),
        n_embd=g("embedding_length"),
        n_head=g("attention.head_count"),
        n_head_kv=g("attention.head_count_kv", g("attention.head_count")),
        n_layer=n_layer,
        n_ff=g("feed_forward_length"),
        rms_eps=g("attention.layer_norm_rms_epsilon", 1e-6),
        rope_base=g("rope.freq_base", 10000.0),
        tie_lm_head="output.weight" not in r.tensors,
    )
    params = {
        "tok_embd": r.load("token_embd.weight", dev),
        "norm": r.load("output_norm.weight", dev),
        "output": r.load("output.weight", dev)
        if "output.weight" in r.tensors else None,
        "blocks": [
            {key: r.load(f"blk.{i}.{nm}.weight", dev)
             for nm, key in _BLOCK_NAMES}
            for i in range(n_layer)
        ],
    }
    return cfg, params


def _dense_f32(t):
    """The writer's copy of a dense leaf: float32, as the JAX writer
    writes every float tensor."""
    if isinstance(t, QTensor):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32)
    return np.asarray(t, np.float32)


def save_gguf_llama(path: str, cfg, params, tokenizer=None) -> dict:
    """Write a llama-arch GGUF (llama.cpp tensor names), the JAX package's
    file byte for byte for the same tree and vocabulary. ``params``: the
    unfused tree (``load_gguf_llama``'s); a fused one (``wqkv``,
    ``w_gate_up``, padded tables) goes through ``llama.unfuse_params`` first.
    Dense leaves are written as F32. ``tokenizer``: an ``SPMTokenizer`` (or
    a (tokens, scores) pair), stored under llama.cpp's ``tokenizer.ggml.*``
    keys so that ``tokenizer.from_gguf`` rebuilds it from the file. Streams
    tensor by tensor; returns each tensor's sha256 of its wire bytes."""
    if any("wqkv" in b for b in params["blocks"]):
        from ..models.llama import unfuse_params

        params = unfuse_params(params, cfg)
    w = GGUFWriter()
    w.add_meta("general.architecture", _T_STR, "llama")
    for key, v in [("block_count", cfg.n_layer),
                   ("context_length", cfg.n_ctx),
                   ("embedding_length", cfg.n_embd),
                   ("attention.head_count", cfg.n_head),
                   ("attention.head_count_kv", cfg.n_head_kv),
                   ("feed_forward_length", cfg.n_ff)]:
        w.add_meta(f"llama.{key}", _T_U32, v)
    if tokenizer is not None:
        toks, scores = (
            (tokenizer.tokens, tokenizer.scores)
            if hasattr(tokenizer, "tokens") else tokenizer)
        w.add_meta("tokenizer.ggml.model", _T_STR, "llama")
        w.add_meta("tokenizer.ggml.tokens", _T_ARR,
                   (_T_STR, [str(t) for t in toks]))
        w.add_meta("tokenizer.ggml.scores", _T_ARR,
                   (_T_F32, [float(s) for s in scores]))
        for key, val in [("bos_token_id", getattr(tokenizer, "bos_id", 1)),
                         ("eos_token_id", getattr(tokenizer, "eos_id", 2)),
                         ("unknown_token_id",
                          getattr(tokenizer, "unk_id", 0))]:
            w.add_meta(f"tokenizer.ggml.{key}", _T_U32, int(val))
    for name, t in llama_tensor_names(params):
        w.add_tensor(name, _dense_f32(t))
    return w.write(path)


def llama_tensor_names(params) -> list:
    """[(llama.cpp tensor name, leaf)] of an unfused Llama tree, in the
    order save_gguf_llama writes them."""
    names = [("token_embd.weight", params["tok_embd"]),
             ("output_norm.weight", params["norm"])]
    if params.get("output") is not None:
        names.append(("output.weight", params["output"]))
    for i, b in enumerate(params["blocks"]):
        names += [(f"blk.{i}.{nm}.weight", b[key]) for nm, key in _BLOCK_NAMES]
    return names


# --- GPT-J (llama.cpp's gptj names) ---------------------------------------

def gptj_tensor_names(params) -> list:
    """[(llama.cpp gptj tensor name, leaf)] of a GPT-J tree, in the order
    save_gguf_gptj writes them."""
    names = [("token_embd.weight", params["wte"]),
             ("output_norm.weight", params["ln_f"]["g"]),
             ("output_norm.bias", params["ln_f"]["b"]),
             ("output.weight", params["lm_head"]["w"]),
             ("output.bias", params["lm_head"]["b"])]
    for i, b in enumerate(params["blocks"]):
        p = f"blk.{i}."
        names += [(p + "attn_norm.weight", b["ln_1"]["g"]),
                  (p + "attn_norm.bias", b["ln_1"]["b"]),
                  (p + "attn_q.weight", b["attn"]["wq"]),
                  (p + "attn_k.weight", b["attn"]["wk"]),
                  (p + "attn_v.weight", b["attn"]["wv"]),
                  (p + "attn_output.weight", b["attn"]["wo"]),
                  (p + "ffn_up.weight", b["mlp"]["fc_in_w"]),
                  (p + "ffn_up.bias", b["mlp"]["fc_in_b"]),
                  (p + "ffn_down.weight", b["mlp"]["fc_out_w"]),
                  (p + "ffn_down.bias", b["mlp"]["fc_out_b"])]
    return names


def save_gguf_gptj(path: str, cfg, params) -> dict:
    """Write a gptj-arch GGUF (llama.cpp's gptj tensor names), the JAX
    package's file byte for byte for the same tree. Dense leaves are written
    as F32. Streams tensor by tensor; returns each tensor's sha256 of its
    wire bytes."""
    w = GGUFWriter()
    w.add_meta("general.architecture", _T_STR, "gptj")
    for key, v in [("block_count", cfg.n_layer),
                   ("context_length", cfg.n_ctx),
                   ("embedding_length", cfg.n_embd),
                   ("attention.head_count", cfg.n_head),
                   ("rope.dimension_count", cfg.rotary_dim)]:
        w.add_meta(f"gptj.{key}", _T_U32, v)
    w.add_meta("gptj.attention.layer_norm_epsilon", _T_F32, float(cfg.ln_eps))
    for name, t in gptj_tensor_names(params):
        w.add_tensor(name, _dense_f32(t))
    return w.write(path)


def load_gguf_gptj(path: str, device=None):
    """A gptj-arch GGUF -> (GPTJConfig, parameter tree) on ``device`` (the
    card unless the caller asks for another). Tensors keep the file's types;
    a file without ``output.weight`` ties the LM head to the embedding, one
    without ``output.bias`` gets a zero f32 bias, as in the JAX package."""
    from ..models.gptj import GPTJConfig

    dev = resolve_device(device)
    r = GGUFReader(path)
    md = r.metadata

    def g(k, d=None):
        return md.get(f"gptj.{k}", d)

    n_layer = g("block_count")
    cfg = GPTJConfig(
        n_vocab=r.tensors["token_embd.weight"].shape[0],
        n_ctx=g("context_length", 2048),
        n_embd=g("embedding_length"),
        n_head=g("attention.head_count"),
        n_layer=n_layer,
        rotary_dim=g("rope.dimension_count", 64),
        ln_eps=g("attention.layer_norm_epsilon", 1e-5),
    )

    def ld(name):
        return r.load(name, dev)

    emb = ld("token_embd.weight")
    params = {
        "wte": emb,
        "ln_f": {"g": ld("output_norm.weight"), "b": ld("output_norm.bias")},
        "lm_head": {
            "w": ld("output.weight") if "output.weight" in r.tensors else emb,
            "b": ld("output.bias") if "output.bias" in r.tensors
            else torch.zeros(cfg.n_vocab, dtype=torch.float32, device=dev),
        },
        "blocks": [],
    }
    for i in range(n_layer):
        p = f"blk.{i}."
        params["blocks"].append({
            "ln_1": {"g": ld(p + "attn_norm.weight"),
                     "b": ld(p + "attn_norm.bias")},
            "attn": {"wq": ld(p + "attn_q.weight"),
                     "wk": ld(p + "attn_k.weight"),
                     "wv": ld(p + "attn_v.weight"),
                     "wo": ld(p + "attn_output.weight")},
            "mlp": {"fc_in_w": ld(p + "ffn_up.weight"),
                    "fc_in_b": ld(p + "ffn_up.bias"),
                    "fc_out_w": ld(p + "ffn_down.weight"),
                    "fc_out_b": ld(p + "ffn_down.bias")},
        })
    return cfg, params
