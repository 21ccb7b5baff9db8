"""The port's GPT-J family (models.gptj, io.gguf's and io.hf's GPT-J
loaders) against the JAX package on the CPU.

Weights cross as ggml wire bytes (test_torch_llama.to_port_tree ->
gptj.params_from_jax), so both packages hold bit-identical parameters. The
config quantizes every matmul weight (n_embd 256, whole 256-element rows),
has a vocabulary that is no multiple of 256, and rotates 16 of each head's
64 dims (partial rotary). A 12-token prompt takes the flash branch of the
head-major cache, the decode steps the einsum branch.

Tolerances on logits (magnitude ~1.2):
  * f32 parameters and cache, float or Q4_0 weights, with or without the
    Q8_0 activation round trip: the packages differ in f32 summation order
    and libm ulps (measured 6e-7..1.1e-6): 2e-5 float, and the llama
    slice's bars for Q4_0, 2e-4 weight-only and 2e-2 with the round trip
    (an input one ulp apart can move an activation by a whole Q8 step);
  * bf16 parameters and cache (the chip path's dtypes; XLA's excess
    precision off, see _jax_forward): a one-ulp f32 difference can round a
    bf16 value a whole step (measured 7.8e-3 float, one bf16 step of a
    logit near 1, and 3.2e-3 Q4_0): 2e-2.
Greedy tokens must agree wherever the JAX top-2 gap exceeds the tolerance.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io import gguf as jgguf
from ggmlsharp_tpu.io import hf as jhf
from ggmlsharp_tpu.models import gptj as jgptj
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.io import gguf, hf
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import gptj, sampling
from ggmlsharp_tpu_torch.quant.formats import QTensor, to_wire
from test_torch_io_hf import _assert_trees_equal
from test_torch_llama import to_port_tree


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package (its CPU matmuls are exact f32 in both of its modes)."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


CFG = dict(n_vocab=300, n_ctx=64, n_embd=256, n_head=4, n_layer=2,
           rotary_dim=16)
PROMPT_LEN, N_NEW = 12, 6

_TREES = {}


def _trees(fmt, dtype):
    """(JAX tree, port tree) of one random GPT-J, ``fmt`` "f" (float) or a
    weight format, parameters in ``dtype`` ("float32" or "bfloat16"); the
    biases are random, not init_params' zeros."""
    key = (fmt, dtype)
    if key not in _TREES:
        jcfg = jgptj.GPTJConfig(**CFG)
        raw = jgptj.init_params(jax.random.PRNGKey(5), jcfg,
                                dtype=getattr(jnp, dtype))
        rng = np.random.default_rng(6)

        def vec(n, std, mean=0.0):
            return jnp.asarray(rng.standard_normal(n) * std + mean,
                               getattr(jnp, dtype))

        E = jcfg.n_embd
        raw["ln_f"] = {"g": vec(E, 0.1, 1.0), "b": vec(E, 0.05)}
        raw["lm_head"]["b"] = vec(jcfg.n_vocab, 0.05)
        for b in raw["blocks"]:
            b["ln_1"] = {"g": vec(E, 0.1, 1.0), "b": vec(E, 0.05)}
            b["mlp"]["fc_in_b"] = vec(jcfg.n_ff, 0.05)
            b["mlp"]["fc_out_b"] = vec(E, 0.05)
        jp = raw if fmt == "f" else jgptj.quantize_params(
            raw, JGType[fmt], swar=False)
        _TREES[key] = (jp, gptj.params_from_jax(to_port_tree(jp),
                                                device="cpu"))
    return _TREES[key]


def _prompt(batch=1, n=PROMPT_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["n_vocab"], (batch, n)).astype(np.int32)


_EXACT = {}


def _jax_forward(jcfg, jp, tokens, cache, positions, t_eff):
    """jgptj.forward under jit, compiled with XLA's excess precision off (as
    test_torch_gpt2._jax_forward: the bf16 stream then rounds where the
    source says so, as PyTorch does)."""
    key = (id(jp), tokens.shape, t_eff, get_config().quantize_activations,
           str(cache.k[0].dtype))
    if key not in _EXACT:
        def fn(p, t, c, pos):
            return jgptj.forward(p, jcfg, t, c, pos, prefix_bound=t_eff)

        _EXACT[key] = jax.jit(fn).lower(jp, tokens, cache, positions).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return _EXACT[key](jp, tokens, cache, positions)


def _steps(jp, tp, prompt, toks, dtype):
    """JAX's and the port's logits [1 + n, B, V] of the prefill and of each
    decode step fed ``toks``."""
    jcfg, tcfg = jgptj.GPTJConfig(**CFG), gptj.GPTJConfig(**CFG)
    B, S = prompt.shape
    jc = jgptj.new_cache(jcfg, B, dtype=getattr(jnp, dtype))
    tc = gptj.new_cache(tcfg, B, dtype=getattr(torch, dtype), device="cpu")
    prefill, step = sampling.make_decode_fns(gptj.forward, tcfg)
    jrows, trows = [], []
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    lg, jc = _jax_forward(jcfg, jp, jnp.asarray(prompt), jc, pos,
                          jsampling.length_bucket(S, jcfg.n_ctx))
    jrows.append(np.asarray(lg[:, -1]))
    with torch.inference_mode():
        t, tc = prefill(tp, torch.from_numpy(prompt), tc,
                        t_eff=sampling.length_bucket(S, tcfg.n_ctx))
        trows.append(t.numpy())
        for i in range(toks.shape[1]):
            tok = toks[:, i:i + 1]
            lg, jc = _jax_forward(
                jcfg, jp, jnp.asarray(tok), jc,
                jnp.full((B, 1), S + i, jnp.int32),
                jsampling.length_bucket(S + i + 1, jcfg.n_ctx))
            jrows.append(np.asarray(lg[:, -1]))
            t, tc = step(tp, torch.from_numpy(tok.copy()), tc,
                         t_eff=sampling.length_bucket(S + i + 1, tcfg.n_ctx))
            trows.append(t.numpy())
    assert int(tc.length[0]) == S + toks.shape[1]
    return np.stack(jrows), np.stack(trows)


@pytest.mark.parametrize("fmt,dtype,quant_acts,tol", [
    ("f", "float32", True, 2e-5), ("f", "bfloat16", True, 2e-2),
    ("Q4_0", "float32", False, 2e-4), ("Q4_0", "float32", True, 2e-2),
    ("Q4_0", "bfloat16", True, 2e-2)],
    ids=["f32", "bf16", "q4_0-weight-only", "q4_0-q8-acts", "q4_0-bf16"])
def test_forward_matches_jax(monkeypatch, fmt, dtype, quant_acts, tol):
    """Prefill (flash) and decode (einsum) logits, step for step, fed JAX's
    greedy tokens; the port's greedy tokens on every decided position."""
    monkeypatch.setattr(get_config(), "quantize_activations", quant_acts)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if quant_acts else "0")
    jp, tp = _trees(fmt, dtype)
    jcfg, tcfg = jgptj.GPTJConfig(**CFG), gptj.GPTJConfig(**CFG)
    prompt = _prompt()
    jtoks, _ = jsampling.generate(jgptj.forward, jcfg, jp,
                                  jnp.asarray(prompt),
                                  jgptj.new_cache(jcfg, 1,
                                                  dtype=getattr(jnp, dtype)),
                                  N_NEW)
    jtoks = np.asarray(jtoks)
    jlog, tlog = _steps(jp, tp, prompt, jtoks[:, :-1], dtype)
    assert np.isfinite(tlog).all() and tlog.shape == (N_NEW, 1, 300)
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=tol)
    ttoks, _ = sampling.generate(
        gptj.forward, tcfg, tp, torch.from_numpy(prompt),
        gptj.new_cache(tcfg, 1, dtype=getattr(torch, dtype), device="cpu"),
        N_NEW)
    top2 = np.sort(jlog[:, 0], axis=-1)[:, -2:]
    for i, (got, want) in enumerate(zip(ttoks[0].tolist(), jtoks[0])):
        if got != want:
            assert top2[i, 1] - top2[i, 0] <= tol, (i, got, want)
            break


def test_batched_positions_per_slot():
    """Two slots at different positions (the engine's case): each slot's
    rotary and attention follow its own positions, as a lone run of that
    slot gives them."""
    _, tp = _trees("f", "float32")
    tcfg = gptj.GPTJConfig(**CFG)
    prompt = _prompt(2, 5, seed=3)
    with torch.inference_mode():
        c = gptj.new_cache(tcfg, 2, dtype=torch.float32, device="cpu")
        c.length[1] = 7  # slot 1 starts 7 rows in (its rows 0..6: zeros)
        pos = c.length[:, None] + torch.arange(5, dtype=torch.int32)[None]
        both, _ = gptj.forward(tp, tcfg, torch.from_numpy(prompt), c, pos)
        for b in (0, 1):
            c1 = gptj.new_cache(tcfg, 1, dtype=torch.float32, device="cpu")
            c1.length[0] = int(c.length[b])
            alone, _ = gptj.forward(tp, tcfg, torch.from_numpy(prompt[b:b + 1]),
                                    c1, pos[b:b + 1])
            torch.testing.assert_close(both[b], alone[0], rtol=0, atol=1e-5)


def test_quantize_params_and_params_from_jax_match_jax():
    """quantize_params gives JAX's blocks bit for bit (wire bytes), leaves
    the 300-row tables' and every matrix's layout as JAX's, keeps biases and
    norms float; params_from_jax carries a JAX GPT-J tree across bit for
    bit."""
    jp, tp = _trees("Q4_0", "float32")
    raw_j, raw_t = _trees("f", "float32")
    q = gptj.quantize_params(raw_t, GType.Q4_0)

    def walk(a, b, j, path=""):
        if isinstance(j, dict):
            for k in j:
                walk(a[k], b[k], j[k], f"{path}/{k}")
        elif isinstance(j, list):
            for i, x in enumerate(j):
                walk(a[i], b[i], x, f"{path}/{i}")
        elif isinstance(a, QTensor):
            assert isinstance(b, QTensor), path
            wire = jgguf.qtensor_to_wire(j)[1]
            assert to_wire(a) == wire == to_wire(b), path
        else:
            assert not isinstance(b, QTensor), path
            np.testing.assert_array_equal(a.numpy(), np.asarray(j), path)
            np.testing.assert_array_equal(b.numpy(), np.asarray(j), path)

    walk(q, tp, jp)
    assert isinstance(q["wte"], QTensor) and q["wte"].shape == (300, 256)
    assert isinstance(q["lm_head"]["w"], QTensor)
    # float params_from_jax: bf16 and f32 leaves keep their bits
    _assert_trees_equal(_trees("f", "bfloat16")[1], _trees("f", "bfloat16")[0])
    _assert_trees_equal(raw_t, raw_j)
    # a narrow tree keeps its weights float, as JAX's does
    tiny_j = jgptj.quantize_params(
        jgptj.init_params(jax.random.PRNGKey(0), jgptj.TINY_GPTJ),
        JGType.Q4_0, swar=False)
    tiny_t = gptj.quantize_params(
        gptj.init_params(gptj.TINY_GPTJ, device="cpu"), GType.Q4_0)
    assert not isinstance(tiny_j["wte"], JQTensor)
    assert not isinstance(tiny_t["wte"], QTensor)


@pytest.mark.parametrize("name", ["GPTJ_6B", "TINY_GPTJ"])
def test_named_configs_match_jax(name):
    a, b = getattr(gptj, name), getattr(jgptj, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.head_dim, a.n_head_kv, a.n_ff) == (b.head_dim, b.n_head_kv,
                                                 b.n_ff)


def test_new_cache_is_head_major():
    c = gptj.new_cache(gptj.TINY_GPTJ, 2, flat=True, device="cpu")
    jc = jgptj.new_cache(jgptj.TINY_GPTJ, 2, flat=True)
    assert not c.is_flat and tuple(c.k[0].shape) == tuple(jc.k[0].shape)
    assert c.k[0].dtype == torch.bfloat16
    assert gptj.new_cache(gptj.TINY_GPTJ, 1, int8=True, device="cpu").int8


def test_synthetic_params_layout_and_plain_route():
    """The chip run's random tree has quantize_params' layout with no f32
    weight, and plain=True gives the same tokens on the CPU (where every
    wrapper is its plain version). Random weights make the next token
    mostly a function of the current one, so a stream may fall into a short
    cycle: no claim is made on how many tokens differ."""
    import functools

    tcfg = gptj.GPTJConfig(**CFG)
    p = gptj.synthetic_params(tcfg, GType.Q4_0, seed=1, device="cpu")
    ref = gptj.quantize_params(gptj.init_params(tcfg, device="cpu"),
                               GType.Q4_0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (type(t).__name__, tuple(t.shape), getattr(t, "gtype", None))

    assert shapes(p) == shapes(ref)
    prompt = torch.from_numpy(_prompt())
    a, _ = sampling.generate(gptj.forward, tcfg, p, prompt,
                             gptj.new_cache(tcfg, 1, device="cpu"), 12)
    b, _ = sampling.generate(functools.partial(gptj.forward, plain=True),
                             tcfg, p, prompt,
                             gptj.new_cache(tcfg, 1, device="cpu"), 12)
    assert torch.equal(a, b) and 0 <= int(a.min()) <= int(a.max()) < 300


@pytest.mark.parametrize("fmt", ["f", "Q4_0", "Q8_0"])
def test_gguf_file_is_jax_byte_for_byte(tmp_path, fmt):
    """save_gguf_gptj writes JAX's file byte for byte (float leaves as F32),
    both loaders read it to the same tree (wire bytes, f32 leaves), the
    digests are those of the bytes in the file, and the loaded tree gives
    the original's logits."""
    jp, tp = _trees("f", "float32") if fmt == "f" else (None, None)
    if jp is None:
        raw_j, _ = _trees("f", "float32")
        jp = jgptj.quantize_params(raw_j, JGType[fmt], swar=False)
        tp = gptj.params_from_jax(to_port_tree(jp), device="cpu")
    jcfg, tcfg = jgptj.GPTJConfig(**CFG), gptj.GPTJConfig(**CFG)
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jgguf.save_gguf_gptj(jpath, jcfg, jp)
    digests = gguf.save_gguf_gptj(tpath, tcfg, tp)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        jb, tb = f.read(), g.read()
    assert len(tb) == len(jb) and tb == jb
    r = gguf.GGUFReader(tpath)
    assert digests == {n: hashlib.sha256(bytes(r.raw(n))).hexdigest()
                       for n in r.tensors}
    jcfg2, jl = jgguf.load_gguf_gptj(jpath)
    tcfg2, tl = gguf.load_gguf_gptj(tpath, device="cpu")
    assert dataclasses.asdict(tcfg2) == dataclasses.asdict(jcfg2)
    # the file holds eps as an f32 value, as llama.cpp's files do
    assert tcfg2.ln_eps == float(np.float32(tcfg.ln_eps))
    assert dataclasses.replace(tcfg2, ln_eps=tcfg.ln_eps) == tcfg
    _assert_same_tree(tl, jl)
    prompt = torch.from_numpy(_prompt(n=5))
    with torch.inference_mode():
        pos = torch.arange(5, dtype=torch.int32)[None]
        a, _ = gptj.forward(tp, tcfg2, prompt, gptj.new_cache(
            tcfg, 1, dtype=torch.float32, device="cpu"), pos)
        b, _ = gptj.forward(tl, tcfg2, prompt, gptj.new_cache(
            tcfg, 1, dtype=torch.float32, device="cpu"), pos)
    assert torch.equal(a, b)


def _assert_same_tree(t, j, path=""):
    """A port tree equal to a JAX one: QTensors by type and wire bytes,
    dense leaves bit for bit (test_torch_io_hf's comparison)."""
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _assert_same_tree(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(j, JQTensor):
        assert isinstance(t, QTensor) and int(t.gtype) == int(j.gtype), path
        assert tuple(t.shape) == tuple(j.shape), path
        assert to_wire(t) == jgguf.qtensor_to_wire(j)[1], path
    else:
        _assert_trees_equal(t, j, path)


def test_gguf_loader_ties_a_missing_head(tmp_path):
    """A file without output.weight / output.bias: both loaders tie the head
    to the embedding with a zero f32 bias."""
    jp, _ = _trees("f", "float32")
    jcfg = jgptj.GPTJConfig(**CFG)
    w = jgguf.GGUFWriter()
    w.add_meta("general.architecture", 8, "gptj")
    for key, v in [("block_count", jcfg.n_layer),
                   ("embedding_length", jcfg.n_embd),
                   ("attention.head_count", jcfg.n_head)]:
        w.add_meta(f"gptj.{key}", 4, v)
    names = [(n, t) for n, t in gguf.gptj_tensor_names(jp)
             if not n.startswith("output.")]
    for n, t in names:
        w.add_tensor(n, np.asarray(t, np.float32))
    path = str(tmp_path / "tied.gguf")
    w.write(path)
    jcfg2, jl = jgguf.load_gguf_gptj(path)
    tcfg2, tl = gguf.load_gguf_gptj(path, device="cpu")
    assert dataclasses.asdict(tcfg2) == dataclasses.asdict(jcfg2)
    assert tcfg2.rotary_dim == 64 and tcfg2.n_ctx == 2048
    assert tl["lm_head"]["w"] is tl["wte"]
    _assert_trees_equal(tl, jl)


def _hf_tensors(dtype, prefix=""):
    g = torch.Generator().manual_seed(0)
    E, V, F = 64, 96, 256

    def r(*s):
        return (torch.randn(s, generator=g) * 0.1).to(dtype)

    t = {"wte.weight": r(V, E), "ln_f.weight": r(E), "ln_f.bias": r(E)}
    for i in range(2):
        p = f"h.{i}."
        t.update({p + "ln_1.weight": r(E), p + "ln_1.bias": r(E),
                  p + "attn.q_proj.weight": r(E, E),
                  p + "attn.k_proj.weight": r(E, E),
                  p + "attn.v_proj.weight": r(E, E),
                  p + "attn.out_proj.weight": r(E, E),
                  p + "mlp.fc_in.weight": r(F, E), p + "mlp.fc_in.bias": r(F),
                  p + "mlp.fc_out.weight": r(E, F),
                  p + "mlp.fc_out.bias": r(E)})
    t = {prefix + k: v for k, v in t.items()}
    if prefix:  # the HF layout: the head beside the transformer
        t["lm_head.weight"], t["lm_head.bias"] = r(V, E), r(V)
    return t


@pytest.mark.parametrize("dt", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("prefix", ["", "transformer."],
                         ids=["tied-head", "hf-layout"])
def test_load_hf_gptj_matches_jax(tmp_path, dt, prefix):
    """load_hf_gptj against JAX's: the same config (from the file's
    config.json) and the same tree bit for bit; without an lm_head, the
    embedding is the head with a zero bias of its dtype."""
    import json

    dtype = {"f32": torch.float32, "f16": torch.float16,
             "bf16": torch.bfloat16}[dt]
    save_file(_hf_tensors(dtype, prefix), str(tmp_path / "m.safetensors"))
    config = {"n_layer": 2, "n_head": 4, "n_positions": 128,
              "rotary_dim": 8, "layer_norm_epsilon": 1e-6}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config, f)
    jcfg, jp = jhf.load_hf_gptj(str(tmp_path))
    tcfg, tp = hf.load_hf_gptj(str(tmp_path), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_vocab, tcfg.n_embd, tcfg.rotary_dim) == (96, 64, 8)
    _assert_trees_equal(tp, jp)
    if not prefix:
        assert tp["lm_head"]["w"] is tp["wte"]
        assert tp["lm_head"]["b"].dtype == dtype
    # the loaded floats run through the port's model
    toks, _ = sampling.generate(gptj.forward, tcfg, tp,
                                torch.tensor([[3, 9, 27]], dtype=torch.int32),
                                gptj.new_cache(tcfg, 1, device="cpu"), 3)
    assert toks.shape == (1, 3) and int(toks.max()) < 96
