"""The port's five user examples (examples/*_torch.py) with --device cpu,
each against its JAX counterpart (examples/*.py), loaded from their files as
test_torch_eval.py loads generate_torch.py.

  * quantize_model_torch: both examples quantize one HF safetensors Llama
    (256 wide, so every matmul weight quantizes) to Q8_0 and Q4_0: the two
    GGUFs hold the same tensors, types and shapes, and the same wire bytes
    except where the JAX example's jitted quantizer rounds a block's scale
    to another f16 (XLA's reciprocal rewrite; at most 2% of blocks, each
    within one f16 ulp of the scale); the tiny random model round-trips
    through the port's loader bit for bit.
  * serve_torch and http_server_torch, with gpt2.GPT2_124M monkeypatched to
    a tiny config: every request gets its tokens, and each greedy request's
    tokens equal sampling.generate's on the same weights up to a near tie
    (the first parting, if any, where the reference's top two logits are
    within 0.05: the engine's batched rows and a b = 1 decode sum in other
    orders, and a one-ulp difference can move a Q8 activation's rounding
    by a step).
  * train_graph_torch: the Test2 line fit (Adam) and L-BFGS on Rosenbrock
    against the JAX example's printed results: t0, t1 and the minimiser
    within 1e-3 (the printed four decimals; f32 trajectories), the result
    names equal.
  * graph_transformer_torch: the decoder built from the JAX example's
    weights (its jax.random draws, in its order): the logits of every step
    within 2e-5 of the JAX graph's (f32 sums in other orders) and the 8
    greedy tokens equal the JAX example's.
Without a card, an example run without --device raises.
"""
import importlib.util
import json
import os
import re
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.io import GGUFReader, load_gguf_llama
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import gpt2, llama, sampling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GPT2 = gpt2.GPT2Config(n_vocab=512, n_ctx=128, n_embd=256, n_head=4,
                            n_layer=2)
NEAR_TIE = 0.05


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run small ops in Python loops, where
    more threads only spin, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _no_card_raises(call):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- quantize_model -------------------------------------------------------

def _hf_llama(tmp_path):
    from safetensors.torch import save_file

    E, F, V, L, H, KV = 256, 512, 320, 2, 8, 4
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g) * 0.05
    t = {"model.embed_tokens.weight": r(V, E), "model.norm.weight": 1 + r(E),
         "lm_head.weight": r(V, E)}
    for i in range(L):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": 1 + r(E),
                  p + "self_attn.q_proj.weight": r(E, E),
                  p + "self_attn.k_proj.weight": r(KV * E // H, E),
                  p + "self_attn.v_proj.weight": r(KV * E // H, E),
                  p + "self_attn.o_proj.weight": r(E, E),
                  p + "post_attention_layernorm.weight": 1 + r(E),
                  p + "mlp.gate_proj.weight": r(F, E),
                  p + "mlp.up_proj.weight": r(F, E),
                  p + "mlp.down_proj.weight": r(E, F)})
    d = tmp_path / "hf"
    d.mkdir()
    save_file(t, str(d / "model.safetensors"))
    with open(d / "config.json", "w") as f:
        json.dump({"num_hidden_layers": L, "hidden_size": E,
                   "num_attention_heads": H, "num_key_value_heads": KV,
                   "intermediate_size": F, "vocab_size": V,
                   "max_position_embeddings": 128, "rms_norm_eps": 1e-5}, f)
    return str(d)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_quantize_model_matches_jax(tmp_path, monkeypatch, capsys, fmt):
    hf = _hf_llama(tmp_path)
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    out = _run_jax_main(_load("quantize_model"),
                        ["--out", a, "--format", fmt, "--hf", hf],
                        monkeypatch, capsys)
    assert out.startswith(f"wrote {a}")
    port = _load("quantize_model_torch")
    assert port.main(["--out", b, "--format", fmt, "--hf", hf,
                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(f"wrote {b}")
    ra, rb = GGUFReader(a), GGUFReader(b)
    assert ra.metadata == rb.metadata
    assert list(ra.tensors) == list(rb.tensors)
    blocks = differ = 0
    for name, ta in ra.tensors.items():
        tb = rb.tensors[name]
        assert (ta.gtype, tuple(ta.shape)) == (tb.gtype, tuple(tb.shape)), name
        xa, xb = ra.raw(name), rb.raw(name)
        if ta.gtype in (GType.F32, GType.F16):
            assert np.array_equal(xa, xb), name
            continue
        bs = 34 if ta.gtype == GType.Q8_0 else 18  # block bytes
        xa, xb = xa.reshape(-1, bs), xb.reshape(-1, bs)
        rows = np.flatnonzero((xa != xb).any(1))
        blocks, differ = blocks + len(xa), differ + len(rows)
        da = xa[rows, :2].copy().view(np.float16).astype(np.float32)
        db = xb[rows, :2].copy().view(np.float16).astype(np.float32)
        assert np.all(np.abs(da - db) <= np.spacing(np.maximum(
            np.abs(da), np.abs(db)).astype(np.float16)).astype(np.float32)), \
            name
    assert blocks > 0 and differ <= 0.02 * blocks


def test_quantize_model_tiny_round_trip(tmp_path, capsys):
    """Without --hf: the tiny random Llama's quantized tree, written and
    loaded back by the port, equal bit for bit."""
    path = str(tmp_path / "tiny.gguf")
    mod = _load("quantize_model_torch")
    assert mod.main(["--out", path, "--format", "q4_0", "--device", "cpu"]) \
        == 0
    cfg, loaded = load_gguf_llama(path, device="cpu")
    assert cfg == llama.LlamaConfig(**mod.TINY)
    raw = llama.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    want = llama.unfuse_params(llama.quantize_params(raw, GType.Q4_0), cfg)

    def same(x, y, name):
        if isinstance(x, dict):
            for k in x:
                same(x[k], y[k], f"{name}.{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                same(u, v, f"{name}[{i}]")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x.float(), y.float()), name
        else:
            assert x.gtype == y.gtype and all(
                torch.equal(x.planes[k], y.planes[k]) for k in x.planes), name

    same(want, loaded, "params")
    _no_card_raises(lambda: mod.main(["--out", path]))


# --- serving --------------------------------------------------------------

def _greedy_reference(cfg, params, prompt, n, int8):
    """(sampling.generate's greedy tokens at b = 1, the top-2 logit gap at
    each of them from one f32 forward over the prompt and the tokens)."""
    p = torch.tensor([prompt], dtype=torch.int32)
    toks, _ = sampling.generate(
        gpt2.forward, cfg, params, p,
        gpt2.new_cache(cfg, 1, int8=int8, device="cpu"), n)
    full = torch.cat([p, toks], 1)
    cache = gpt2.new_cache(cfg, 1, dtype=torch.float32, device="cpu")
    logits, _ = gpt2.forward(params, cfg, full[:, :-1], cache,
                             torch.arange(full.shape[1] - 1,
                                          dtype=torch.int32)[None])
    top2 = torch.topk(logits[0, len(prompt) - 1:], 2).values
    return toks[0].tolist(), (top2[:, 0] - top2[:, 1]).tolist()


def _held(got, want, gaps, what):
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert gaps[j] < NEAR_TIE, (what, j, gaps[j])
            return j
    return len(got)


@pytest.mark.parametrize("flags", [[], ["--int8-kv", "--prefix", "--stream"],
                                   ["--draft"]],
                         ids=["plain", "int8_prefix_stream", "draft"])
def test_serve_torch(monkeypatch, capsys, flags):
    monkeypatch.setattr(gpt2, "GPT2_124M", TINY_GPT2)
    mod = _load("serve_torch")
    args = mod.parse(["--requests", "4", "--slots", "2", "--device", "cpu"]
                     + flags)
    eng, params, results, _ = mod.serve(args)
    assert sorted(r.id for r in results) == list(range(4))
    int8 = "--int8-kv" in flags
    for r in results:
        assert r.error is None and len(r.out_tokens) == r.max_new_tokens
        if r.temperature == 0.0:
            want, gaps = _greedy_reference(TINY_GPT2, params, r.prompt,
                                           r.max_new_tokens, int8)
            _held(r.out_tokens, want, gaps, f"req {r.id}")
    out = capsys.readouterr().out
    if "--stream" in flags:
        assert out.count("[stream]") == sum(len(r.out_tokens)
                                            for r in results)
    if not flags:
        assert mod.main(["--requests", "2", "--device", "cpu"]) == 0
        assert "served 2 requests" in capsys.readouterr().out
        _no_card_raises(lambda: mod.main(["--requests", "1"]))


def test_http_server_torch(monkeypatch):
    monkeypatch.setattr(gpt2, "GPT2_124M", TINY_GPT2)
    mod = _load("http_server_torch")
    srv = mod.start(mod.parse(["--port", "0", "--slots", "2",
                               "--device", "cpu"]))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/generate",
            data=json.dumps({"prompt": [1, 2, 3],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        srv.stop()
    assert out["error"] is None and len(out["tokens"]) == 6
    want, gaps = _greedy_reference(TINY_GPT2, srv.engine.params, [1, 2, 3],
                                   6, False)
    _held(out["tokens"], want, gaps, "http")
    _no_card_raises(lambda: mod.start(mod.parse(["--port", "0"])))


# --- the graph layer ------------------------------------------------------

FIT_ITERS = 600  # the line fit's Adam iterations, both examples


def _parse_train_graph(out):
    num = r"(-?[\d.]+(?:e[-+]\d+)?)"
    fit = [float(v) for v in re.search(f"t0={num} t1={num}", out).groups()]
    a, b, f, iters, res = re.search(
        rf"\({num}, {num}\) f={num} in (\d+) iters \((\w+)\)", out).groups()
    return fit, (float(a), float(b)), float(f), res


def test_train_graph_torch_matches_jax(monkeypatch, capsys):
    """Both examples with the line fit cut to FIT_ITERS Adam iterations
    (each package's ggml_opt_default_params capped alike; the full fit
    takes ~9.5k, 10 s on the port's CPU route): the same point after the
    same steps, and L-BFGS's Rosenbrock minimum."""
    from ggmlsharp_tpu_torch import compat

    def capped(default):
        def params(type_):
            p = default(type_)
            p.adam.n_iter = FIT_ITERS
            return p
        return params

    jmod = _load("train_graph")
    monkeypatch.setattr(jmod, "ggml_opt_default_params",
                        capped(jmod.ggml_opt_default_params))
    (t0, t1), (a, b), f, res = _parse_train_graph(
        _run_jax_main(jmod, [], monkeypatch, capsys))
    monkeypatch.setattr(compat, "ggml_opt_default_params",
                        capped(compat.ggml_opt_default_params))
    mod = _load("train_graph_torch")
    assert mod.main(["--device", "cpu"]) == 0
    (pt0, pt1), (pa, pb), pf, pres = _parse_train_graph(
        capsys.readouterr().out)
    assert abs(pt0 - t0) <= 1e-3 and abs(pt1 - t1) <= 1e-3
    assert t1 > 1.0  # the fit moved
    assert abs(pa - a) <= 1e-3 and abs(pb - b) <= 1e-3
    assert pres == res == "OK" and pf <= max(f, 1e-8)
    _no_card_raises(lambda: mod.main([]))


def test_graph_transformer_torch_matches_jax(monkeypatch, capsys):
    jmod = _load("graph_transformer")
    out = _run_jax_main(jmod, [], monkeypatch, capsys)
    want = json.loads(out.split(":", 1)[1])
    L = 2
    ks = iter(jax.random.split(jax.random.PRNGKey(0), 4 + 8 * L))
    draw = lambda shape: torch.from_numpy(np.array(
        jax.random.normal(next(ks), shape, jnp.float32) * 0.08))
    mod = _load("graph_transformer_torch")
    tok, graph, logits = mod.build_model(draw, "cpu", L=L)
    got = mod.greedy(tok, graph, logits, [5, 17, 33], 8)
    assert got == want
    # the logits of the last window, against the JAX graph's
    jtok, jgraph, jlogits = jmod.build_model(jax.random.PRNGKey(0))
    window = np.zeros((16,), np.int32)
    seq = [5, 17, 33] + got
    window[:len(seq) - 1] = seq[:-1][-16:]
    from ggmlsharp_tpu.graph import set_data as jset_data
    from ggmlsharp_tpu_torch.graph import set_data

    jset_data(jtok, window)
    jgraph.compute()
    set_data(tok, torch.from_numpy(window))
    graph.compute()
    np.testing.assert_allclose(logits.data.numpy(), np.asarray(jlogits.data),
                               rtol=2e-5, atol=2e-5)
    assert mod.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(
        "graph-API transformer greedy decode: [")
    _no_card_raises(lambda: mod.main([]))
