"""The port's GGUF reader and writer against the JAX package's, on the CPU.

Files are written here, from seeded weights: wire round trips in every
format that has a GGUF type id, a JAX-written Llama file read by the port,
the port's file byte for byte against JAX's ``save_gguf_llama``, and the
logits of the loaded tree against JAX's on the same file.

Tolerance: weight-only (no activation round trip) with the port in mm_dot
"f32", the two packages differ in f32 summation order alone: 1e-4 on logits
of magnitude ~1, the bar of ``test_torch_llama.py``. A loaded tree and the
in-memory tree it was written from hold the same bits, so every route of
``llama.forward`` gives them equal logits.
"""
import dataclasses
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io import gguf as jgguf
from ggmlsharp_tpu.io.tokenizer import SPMTokenizer as JSPM
from ggmlsharp_tpu.io.tokenizer import train_spm_vocab as jtrain
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.io import gguf
from ggmlsharp_tpu_torch.io.tokenizer import SPMTokenizer
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import llama, sampling
from ggmlsharp_tpu_torch.quant.formats import QTensor, to_wire

WIRE_FORMATS = [GType.Q4_0, GType.Q4_1, GType.Q5_0, GType.Q5_1, GType.Q8_0,
                GType.Q8_1, GType.Q4_K, GType.Q6_K, GType.Q8_K]
# every matmul weight and both tables quantized (n_embd 256); MHA, so that
# the whole-block route's gate (E_kv % 256 == 0) passes
CFG = dict(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_head_kv=4,
           n_layer=2, n_ff=512)
TINY = dataclasses.asdict(llama.TINY_LLAMA)


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


def to_port_tree(x):
    """JAX parameter tree -> numpy / (gtype, wire bytes, shape) leaves."""
    if isinstance(x, JQTensor):
        g, wire = jgguf.qtensor_to_wire(x)
        return (int(g), wire, x.shape)
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_port_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port_tree(v) for v in x]
    return np.asarray(x)


CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "tiny_corpus.txt")


def _vocab():
    with open(CORPUS) as f:
        return jtrain(f.read()[:6000], size=300)


_TREES = {}


def jax_tree(cfg_args, fmt):
    """JAX's unfused tree of ``fmt`` (f32 norms) and the port's copy of it,
    carried across as wire bytes."""
    key = (tuple(sorted(cfg_args.items())), fmt)
    if key not in _TREES:
        jcfg = jllama.LlamaConfig(**cfg_args)
        raw = jllama.init_params(jax.random.PRNGKey(7), jcfg,
                                 dtype=jnp.float32)
        jq = jllama.quantize_params(raw, JGType[fmt], fuse=False, swar=False,
                                    pad_rows_to=1)
        _TREES[key] = (jcfg, jq, llama.params_from_jax(to_port_tree(jq),
                                                      device="cpu"))
    return _TREES[key]


@pytest.mark.parametrize("gtype", WIRE_FORMATS + [GType.F32, GType.F16],
                         ids=lambda g: g.name)
def test_wire_roundtrip(tmp_path, gtype):
    """Port writer -> port reader: the same planes (Q8_1's f32 d and s
    rounded to the wire's f16), the same wire bytes, and the digests the
    writer returns are those of the bytes in the file."""
    x = torch.from_numpy(np.random.default_rng(int(gtype)).standard_normal(
        (4, 512)).astype(np.float32))
    t = {GType.F32: x, GType.F16: x.half()}.get(gtype)
    t = quantize(x, gtype) if t is None else t
    w = gguf.GGUFWriter()
    w.add_meta("general.architecture", 8, "llama")
    w.add_tensor("t", t)
    w.add_tensor("f", x[:3, :7].contiguous())
    path = str(tmp_path / "t.gguf")
    digests = w.write(path)
    r = gguf.GGUFReader(path)
    assert r.tensors["t"].gtype == gtype and r.tensors["t"].shape == (4, 512)
    back = r.load("t", device="cpu")
    wire = gguf.qtensor_to_wire(back)[1]
    assert wire == gguf.qtensor_to_wire(t)[1] == bytes(r.raw("t"))
    assert digests["t"] == hashlib.sha256(wire).hexdigest()
    if isinstance(t, QTensor):
        for k, v in t.planes.items():
            if gtype == GType.Q8_1 and k in ("d", "s"):
                v = v.half().float()  # f32 planes, f16 on the wire
            assert torch.equal(back[k], v), k
    else:
        assert torch.equal(back, t)
    assert torch.equal(r.load("f", device="cpu"), x[:3, :7])
    # the JAX reader sees the same tensor
    jr = jgguf.GGUFReader(path)
    assert jgguf.qtensor_to_wire(jr.load("t", use_native=False))[1] == wire


@pytest.mark.parametrize("fmt", ["Q4_2", "Q4_3"])
def test_writer_refuses_formats_without_a_gguf_id(fmt):
    """Q4_2 and Q4_3 have no GGUF type id: both writers refuse them."""
    from ggmlsharp_tpu import quantize as jquantize

    x = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
    with pytest.raises(KeyError):
        jgguf.GGUFWriter().add_tensor("w", jquantize(jnp.asarray(x),
                                                     JGType[fmt]))
    with pytest.raises(ValueError, match="no GGUF type id"):
        gguf.GGUFWriter().add_tensor("w", quantize(torch.from_numpy(x),
                                                   GType[fmt]))


def test_port_reads_a_jax_written_file(tmp_path):
    """A file of the JAX writer (Q4_K tree, vocabulary): the port reads its
    metadata, each tensor's wire bytes and its LlamaConfig as JAX does."""
    jcfg, jq, _ = jax_tree(CFG, "Q4_K")
    toks, scores = _vocab()
    path = str(tmp_path / "j.gguf")
    jgguf.save_gguf_llama(path, jcfg, jq, tokenizer=JSPM(toks, scores))
    jr, r = jgguf.GGUFReader(path), gguf.GGUFReader(path)
    assert r.metadata == jr.metadata
    assert r.metadata["tokenizer.ggml.tokens"] == toks
    assert list(r.tensors) == list(jr.tensors)
    for name, ti in r.tensors.items():
        jt = jr.tensors[name]
        assert (ti.shape, ti.gtype, ti.offset, ti.nbytes) == \
            (jt.shape, GType(int(jt.gtype)), jt.offset, jt.nbytes)
        want = jgguf.qtensor_to_wire(jr.load(name, use_native=False))[1]
        assert gguf.qtensor_to_wire(r.load(name, device="cpu"))[1] == want
    jcfg2, _ = jgguf.load_gguf_llama(path)
    cfg2, _ = gguf.load_gguf_llama(path, device="cpu")
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
    assert cfg2 == llama.LlamaConfig(**CFG)


@pytest.mark.parametrize("cfg_args,fmt,vocab", [
    (TINY, "Q4_0", False), (TINY, "Q4_0", True),
    (CFG, "Q4_0", False), (CFG, "Q4_0", True),
    (CFG, "Q4_K", False), (CFG, "Q4_K", True),
    (CFG, "Q8_0", False), (CFG, "Q8_0", True)],
    ids=["tiny-q4_0", "tiny-q4_0-vocab", "q4_0", "q4_0-vocab", "q4_k",
         "q4_k-vocab", "q8_0", "q8_0-vocab"])
def test_file_is_jax_byte_for_byte(tmp_path, cfg_args, fmt, vocab):
    """The port's save_gguf_llama writes JAX's file, byte for byte, for the
    same tree and vocabulary (TINY_LLAMA keeps its 128-wide weights dense:
    F32 tensors beside w_down's blocks)."""
    jcfg, jq, tq = jax_tree(cfg_args, fmt)
    toks, scores = _vocab() if vocab else (None, None)
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jgguf.save_gguf_llama(jpath, jcfg, jq, tokenizer=JSPM(toks, scores)
                          if vocab else None)
    gguf.save_gguf_llama(tpath, llama.LlamaConfig(**cfg_args), tq,
                         tokenizer=SPMTokenizer(toks, scores)
                         if vocab else None)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        jb, tb = f.read(), g.read()
    assert len(tb) == len(jb) and tb == jb


def test_fused_and_padded_tree_writes_the_same_file(tmp_path):
    """A tree in the port's own layout (wqkv, w_gate_up, tables padded to
    PAD_ROWS) goes through llama.unfuse_params: the same file as its
    unfused, unpadded tree."""
    cfg = llama.LlamaConfig(**{**CFG, "n_vocab": 200})
    raw = llama.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu", dtype=torch.float32)
    fused = llama.quantize_params(raw, GType.Q8_0)
    assert fused["tok_embd"].shape[0] == llama.PAD_ROWS
    plain = llama.unfuse_params(fused, cfg)
    assert plain["tok_embd"].shape[0] == 200
    a, b = str(tmp_path / "a.gguf"), str(tmp_path / "b.gguf")
    da = gguf.save_gguf_llama(a, cfg, fused)
    db = gguf.save_gguf_llama(b, cfg, plain)
    assert da == db
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    cfg2, back = gguf.load_gguf_llama(a, device="cpu")
    assert cfg2 == cfg
    refused = llama.fuse_params(back)
    for k in ("wqkv", "w_gate_up", "wo", "w_down"):
        assert to_wire(refused["blocks"][1][k]) == \
            to_wire(fused["blocks"][1][k]), k


def _weight_only(monkeypatch):
    monkeypatch.setattr(get_config(), "quantize_activations", False)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "0")


def _prompt(n=12):
    return np.random.default_rng(3).integers(
        0, CFG["n_vocab"], (1, n)).astype(np.int32)


def _port_logits(cfg, params, **cache_kw):
    prompt = torch.from_numpy(_prompt())
    with torch.inference_mode():
        lg, _ = llama.forward(
            params, cfg, prompt,
            llama.new_cache(cfg, 1, device="cpu", **cache_kw),
            torch.arange(prompt.shape[1], dtype=torch.int32)[None],
            prefix_bound=cfg.n_ctx)
    return lg[0].numpy()


def test_loaded_logits_match_jax(tmp_path, monkeypatch):
    """Weight-only, one 12-token forward of JAX's load_gguf_llama and the
    port's of the same file: within 1e-4."""
    _weight_only(monkeypatch)
    jcfg, jq, _ = jax_tree(CFG, "Q4_0")
    path = str(tmp_path / "m.gguf")
    jgguf.save_gguf_llama(path, jcfg, jq)
    jcfg2, jp = jgguf.load_gguf_llama(path)
    jp = jax.tree.map(jnp.asarray, jp)
    fwd = jax.jit(lambda p, t, c, pos: jllama.forward(
        p, jcfg2, t, c, pos, prefix_bound=jcfg2.n_ctx)[0])
    want = np.asarray(fwd(jp, jnp.asarray(_prompt()),
                          jllama.new_cache(jcfg2, 1, dtype=jnp.float32),
                          jnp.arange(12, dtype=jnp.int32)[None]))[0]
    cfg2, tp = gguf.load_gguf_llama(path, device="cpu")
    got = _port_logits(cfg2, tp, dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got_fused = _port_logits(cfg2, llama.fuse_params(tp), dtype=torch.float32)
    np.testing.assert_allclose(got_fused, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("route", ["unfused", "fused", "fused-flat",
                                   "fused-int8", "mlp_fused",
                                   "layer_fused"])
def test_loaded_tree_takes_every_route(tmp_path, monkeypatch, route):
    """The loaded (unfused, unpadded) tree through each route of
    llama.forward: as it is (head-major cache), after fuse_params (head-major,
    flat bf16 and flat INT8 caches), and after quantize_params with the fused
    MLP or the whole-block route. Each gives, for a prompt and 4 greedy
    tokens, the logits and tokens of the tree it was written from."""
    _weight_only(monkeypatch)
    _, _, tq = jax_tree(CFG, "Q4_0")
    cfg = llama.LlamaConfig(**CFG)
    path = str(tmp_path / "m.gguf")
    gguf.save_gguf_llama(path, cfg, tq)
    _, loaded = gguf.load_gguf_llama(path, device="cpu")

    def make(tree):
        if route == "unfused":
            return tree
        if route in ("mlp_fused", "layer_fused"):
            return llama.quantize_params(
                tree, GType.Q4_0, cfg=cfg, mlp_fused=route == "mlp_fused",
                layer_fused=route == "layer_fused")
        return llama.fuse_params(tree)

    cache_kw = {"fused-flat": dict(flat=True, dtype=torch.bfloat16),
                "fused-int8": dict(int8=True),
                "layer_fused": dict(flat=True, dtype=torch.float32)}.get(
                    route, dict(dtype=torch.float32))
    a, b = make(tq), make(loaded)
    if route == "mlp_fused":
        assert all("mlp_fused" in blk for blk in b["blocks"])
    if route == "layer_fused":
        assert all("layer_fused" in blk for blk in b["blocks"])
    out = []
    for tree in (a, b):
        prompt = torch.from_numpy(_prompt(6))
        toks, _ = sampling.generate(
            llama.forward, cfg, tree, prompt,
            llama.new_cache(cfg, 1, device="cpu", **cache_kw), 4)
        out.append((_port_logits(cfg, tree, **cache_kw), toks))
    assert np.isfinite(out[1][0]).all() and out[1][0].shape == (12, 256)
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert torch.equal(out[1][1], out[0][1])


def test_loader_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, tq = jax_tree(TINY, "Q4_0")
    path = str(tmp_path / "m.gguf")
    gguf.save_gguf_llama(path, llama.TINY_LLAMA, tq)
    for call in (lambda: gguf.load_gguf_llama(path),
                 lambda: gguf.GGUFReader(path).load("token_embd.weight"),
                 lambda: gguf.GGUFReader(path).load("blk.0.ffn_down.weight")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
