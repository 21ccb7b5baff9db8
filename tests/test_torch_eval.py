"""The port's perplexity and quantization quality against the JAX package's,
on the CPU, and the two user paths that tokenize text: ``examples/
generate_torch.py --prompt`` on a GGUF that carries a vocabulary, and an
EngineServer "text" request.

Parameters are f32, drawn in numpy from a seed and handed to both packages
(quantized weights as ggml wire bytes). Tolerances: with f32 weights and an
f32 cache the packages differ in f32 summation order and libm ulps, as in
``test_torch_train.py`` (the loss to 1e-5): the mean NLL and the perplexity
to 1e-5 relative, the scored count exactly. The logits KL of a Q8_0 copy,
weight-only (logits within 1e-4, ``test_torch_llama.py``'s bar), on one
stream: within 1e-5 + 1e-3 of its value. A sampled stream cannot match
across the packages (a torch.Generator is not a JAX key); the JAX test's
Q8 property is held on the port's own."""
import importlib.util
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.eval import perplexity as jppl
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.models import kv_cache as jkvc
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.eval import (compare_quantizers, logits_kl,
                                      perplexity, quantization_quality)
from ggmlsharp_tpu_torch.io import (SPMTokenizer, save_gguf_llama,
                                    train_spm_vocab)
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import gpt2, llama, sampling
from ggmlsharp_tpu_torch.models.common import params_from_jax
from ggmlsharp_tpu_torch.serving import Engine, EngineServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data", "tiny_corpus.txt")) as _f:
    TEXT = _f.read()
GPT2_CFG = dict(n_vocab=128, n_ctx=64, n_embd=64, n_head=4, n_layer=2)
# 256 wide, so that Q8_0 quantizes every matmul weight
GPT2_Q = dict(n_vocab=128, n_ctx=64, n_embd=256, n_head=4, n_layer=2)
MODELS = {
    "gpt2": (jgpt2, gpt2, GPT2_CFG),
    "tiny_llama": (jllama, llama, {k: getattr(llama.TINY_LLAMA, k) for k in (
        "n_vocab", "n_ctx", "n_embd", "n_head", "n_head_kv", "n_layer",
        "n_ff")}),
}


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


def _to_port(x):
    if isinstance(x, JQTensor):
        g, wire = qtensor_to_wire(x)
        return (int(g), wire, x.shape)
    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_port(v) for v in x]
    return None if x is None else np.asarray(x)


def _models(name, cfg_args=None, seed=0):
    """f32 parameters of JAX's init_params structure, drawn in numpy: N(0,
    0.05) weights, gains 1 + N(0, 0.25), in both packages."""
    jmod, tmod, args = MODELS[name]
    args = cfg_args or args
    jcfg = (jgpt2.GPT2Config if name == "gpt2" else jllama.LlamaConfig)(**args)
    tcfg = (gpt2.GPT2Config if name == "gpt2" else llama.LlamaConfig)(**args)
    rng = np.random.default_rng(seed)
    tree = jmod.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)

    def draw(path, a):
        x = rng.standard_normal(a.shape).astype(np.float32) * 0.05
        if jax.tree_util.keystr(path).endswith(("['g']", "norm']")):
            x = 1.0 + x * 5
        return x

    tree = jax.tree_util.tree_map_with_path(draw, tree)
    return (jmod, tmod, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(_to_port(tree), device="cpu"))


def _stream(n, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("tail", [True, False])
def test_perplexity_matches_jax(name, tail):
    jmod, tmod, jcfg, tcfg, jp, tp = _models(name)
    stream = _stream(150, tcfg.n_vocab)
    want = jppl(jmod.forward, jcfg, jp, stream,
                                  chunk_len=32, stride=24,
                                  score_tail_only=tail)
    got = perplexity(tmod.forward, tcfg, tp, stream, chunk_len=32, stride=24,
                     score_tail_only=tail)
    assert got[2] == want[2] > 0
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert abs(np.exp(got[1]) - got[0]) < 1e-9 * got[0]


def test_perplexity_deterministic():
    _, tmod, _, tcfg, _, tp = _models("gpt2")
    stream = np.arange(150) % tcfg.n_vocab
    p1 = perplexity(tmod.forward, tcfg, tp, stream, chunk_len=64)
    p2 = perplexity(tmod.forward, tcfg, tp, stream, chunk_len=64)
    assert p1 == p2 and p1[2] > 0 and 1.0 < p1[0] < tcfg.n_vocab * 10


def _jax_kl(jcfg, jp_fp, jp_q, stream, chunk_len):
    """JAX's quantization_quality logits KL (eval/perplexity.py), on a
    given stream."""
    chunk = jnp.asarray(stream[:chunk_len][None])

    def logits_of(p):
        cache = jkvc.init_cache(jcfg.n_layer, 1, jcfg.n_head, chunk_len,
                                jcfg.head_dim, dtype=jnp.float32)
        pos = jnp.arange(chunk_len, dtype=jnp.int32)[None]
        lg, _ = jax.jit(lambda q, t, c, ps: jgpt2.forward(q, jcfg, t, c, ps))(
            p, chunk, cache, pos)
        return jax.nn.log_softmax(lg.astype(jnp.float32), axis=-1)

    a, b = logits_of(jp_fp), logits_of(jp_q)
    return float(jnp.mean(jnp.sum(jnp.exp(a) * (a - b), axis=-1)))


def test_quantization_quality_matches_jax_on_a_stream(monkeypatch):
    """Weight-only Q8_0 of a 256-wide GPT-2, one stream: the port's logits
    KL and Δppl against JAX's on that stream."""
    monkeypatch.setattr(get_config(), "quantize_activations", False)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "0")
    # the JAX tree without its fused routes' TPU planes (the port's forward
    # has no such copies to take)
    monkeypatch.setenv("GGML_TPU_LAYER_FUSED", "0")
    monkeypatch.setenv("GGML_TPU_MLP_FUSED", "0")
    _, _, jcfg, tcfg, jp, tp = _models("gpt2", GPT2_Q)
    jq = jgpt2.quantize_params(jp, JGType.Q8_0, swar=False)
    tq = params_from_jax(_to_port(jq), device="cpu")
    assert isinstance(tq["blocks"][0]["mlp"]["c_fc_w"], type(tq["wte"]))
    stream = _stream(96, tcfg.n_vocab, seed=5)
    want_kl = _jax_kl(jcfg, jp, jq, stream, 48)
    got = quantization_quality(gpt2.forward, tcfg, tp, tq, chunk_len=48,
                               stream=stream)
    assert want_kl > 0
    assert abs(got["mean_kl"] - want_kl) <= 1e-5 + 1e-3 * want_kl
    assert got["mean_kl"] == logits_kl(gpt2.forward, tcfg, tp, tq, stream,
                                       48)
    jfp = jppl(jgpt2.forward, jcfg, jp, stream, 48)[0]
    jpq = jppl(jgpt2.forward, jcfg, jq, stream, 48)[0]
    np.testing.assert_allclose(got["ppl_fp"], jfp, rtol=1e-5)
    np.testing.assert_allclose(got["ppl_q"], jpq, rtol=1e-5)


def test_quantization_quality_q8_small_delta():
    """The JAX test's property on the port's own sampled stream: Q8_0 moves
    a tiny random model little; identical parameters give exactly 0. The
    same generator seed gives the same stream and numbers."""
    _, _, _, tcfg, _, tp = _models("gpt2", GPT2_Q)
    tq = gpt2.quantize_params(tp, GType.Q8_0)
    q = quantization_quality(gpt2.forward, tcfg, tp, tq, n_tokens=48,
                             chunk_len=32)
    assert abs(q["delta_ppl"]) < 0.5 * q["ppl_fp"]
    assert 0 < q["mean_kl"] < 0.05
    q0 = quantization_quality(gpt2.forward, tcfg, tp, tp, n_tokens=48,
                              chunk_len=32)
    assert q0["mean_kl"] == 0.0 and q0["delta_ppl"] == 0.0
    again = quantization_quality(gpt2.forward, tcfg, tp, tq, n_tokens=48,
                                 chunk_len=32,
                                 rng=torch.Generator().manual_seed(0))
    assert again == q
    ladder = compare_quantizers(gpt2.forward, tcfg, tp, {
        "q8_0": lambda p: gpt2.quantize_params(p, GType.Q8_0),
        "q4_0": lambda p: gpt2.quantize_params(p, GType.Q4_0)},
        n_tokens=48, chunk_len=32)
    assert ladder["q8_0"] == q
    assert ladder["q4_0"]["mean_kl"] > ladder["q8_0"]["mean_kl"]


def _tiny_gguf(tmp_path):
    """A TINY_LLAMA-shaped Q8_0 model whose vocabulary was trained on the
    corpus, written to a GGUF with that vocabulary."""
    toks, scores = train_spm_vocab(TEXT[:6000], size=300)
    cfg = llama.LlamaConfig(n_vocab=len(toks), n_ctx=64, n_embd=256,
                            n_head=4, n_head_kv=2, n_layer=2, n_ff=512)
    raw = llama.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu", dtype=torch.float32)
    params = llama.quantize_params(raw, GType.Q8_0)
    tk = SPMTokenizer(toks, scores)
    path = str(tmp_path / "tiny.gguf")
    save_gguf_llama(path, cfg, params, tokenizer=tk)
    return path, cfg, params, tk


def test_generate_torch_example_with_a_prompt(tmp_path, capsys):
    """examples/generate_torch.py --gguf --prompt --device cpu: it encodes
    the prompt with the file's vocabulary, and prints the greedy tokens of
    the loaded model and their text."""
    path, cfg, params, tk = _tiny_gguf(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(ROOT, "examples", "generate_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    prompt = "the numbers move through"
    assert mod.main(["--gguf", path, "--device", "cpu", "--prompt", prompt,
                     "--tokens", "5"]) == 0
    out = capsys.readouterr().out.split("\n")
    ids = json.loads(out[0].split(":", 1)[1])
    want, _ = sampling.generate(
        llama.forward, cfg, params,
        torch.tensor([tk.encode(prompt)], dtype=torch.int32), llama.new_cache(
            cfg, 1, device="cpu"), 5)
    assert ids == want[0].tolist()
    assert out[1] == "text: " + tk.decode(ids)
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--gguf", path, "--prompt", prompt])


def test_engine_server_text_request(tmp_path):
    """A "text" request through EngineServer with the port's SPM tokenizer:
    the prompt is encoded with it, and the answer carries the engine's
    tokens and their decoded text."""
    _, cfg, params, tk = _tiny_gguf(tmp_path)
    text = "A tensor library stores numbers"
    eng = Engine(llama.forward, cfg, params, batch_slots=2, device="cpu")
    srv = EngineServer(eng, port=0, tokenizer=tk).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/generate",
            data=json.dumps({"text": text, "max_new_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        srv.stop()
    assert out["error"] is None and 1 <= len(out["tokens"]) <= 4
    assert out["text"] == tk.decode(out["tokens"])
    ref = Engine(llama.forward, cfg, params, batch_slots=2, device="cpu")
    from ggmlsharp_tpu_torch.serving import Request

    ref.submit(Request(id=0, prompt=tk.encode(text), max_new_tokens=4,
                       eos_id=tk.eos_id))
    assert ref.run()[0].out_tokens == out["tokens"]
