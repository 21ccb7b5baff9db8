"""The port's perplexity chain (ggmlsharp_tpu_torch/eval/chain.py, the
functions of scripts/ppl_chain_torch.py) against the JAX package's
(scripts/ppl_chain.py), at the size of the JAX package's slow chain test
(tests/test_eval.py:52-117): 8000 corpus characters, vocabulary 384, a
2L/128E/4-head/256F Llama, 64-token chunks, here 3 Adam steps from the same
parameters.

Held against JAX, step by step:
  * the trained vocabulary and the corpus ids: equal;
  * every Adam step's loss: 1e-5 relative (f32 sums in other orders; the
    chain's loss is one forward of every chunk);
  * the port's GGUF, loaded by JAX's load_gguf_llama: every tensor equal to
    the port's trained one, and the vocabulary equal;
  * held-out perplexity of the reloaded weights at fp32 (1e-5 relative:
    f32 summation order and libm ulps), Q8_0 with and without activation
    rounding and Q4_K (1e-4 relative: the same quantized weights; a
    one-ulp difference can move an activation's Q8 rounding by a step,
    which moves a logit by ~1e-3 and the mean NLL by far less).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.eval.perplexity import perplexity as jperplexity
from ggmlsharp_tpu.io.gguf import GGUFReader as JGGUFReader
from ggmlsharp_tpu.io.gguf import load_gguf_llama as jload_gguf_llama
from ggmlsharp_tpu.io.tokenizer import SPMTokenizer as JSPMTokenizer
from ggmlsharp_tpu.io.tokenizer import from_gguf as jfrom_gguf
from ggmlsharp_tpu.io.tokenizer import train_spm_vocab as jtrain_spm_vocab
from ggmlsharp_tpu.models import kv_cache as jkvc
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.optim import AdamParams as JAdamParams
from ggmlsharp_tpu.optim import OptParams as JOptParams
from ggmlsharp_tpu.optim import opt_adam as jopt_adam
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.eval import chain
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import llama
from ggmlsharp_tpu_torch.models.common import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64
CFG = dict(n_ctx=128, n_embd=128, n_head=4, n_head_kv=4, n_layer=2,
           n_ff=256)


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """JAX's CPU matmuls compute the "f32" function in either mode."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run small ops in Python loops, where
    more threads only spin, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text():
    with open(os.path.join(ROOT, "tests", "data", "tiny_corpus.txt")) as f:
        return f.read()[:8000]


def _jax_nll(jcfg, toks):
    X, Y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    B = X.shape[0]

    def nll(p):
        cache = jkvc.init_cache(jcfg.n_layer, B, jcfg.n_head_kv, S,
                                jcfg.head_dim, dtype=jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        logits, _ = jllama.forward(p, jcfg, X, cache, pos)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(lp, Y[..., None], -1).mean()

    return nll


def _wire(x):
    return None if x is None else (
        {k: _wire(v) for k, v in x.items()} if isinstance(x, dict) else
        [_wire(v) for v in x] if isinstance(x, list) else np.asarray(x))


def _jax_ppl(jcfg, jp, heldout, gt=None, qa=True):
    if gt is not None:
        jp = jllama.quantize_params(jp, gt, cfg=jcfg)
    prev = get_config().quantize_activations
    get_config().quantize_activations = qa
    try:
        return jperplexity(jllama.forward, jcfg, jp, heldout, chunk_len=S)
    finally:
        get_config().quantize_activations = prev


def test_chain_matches_jax(tmp_path):
    text = _text()
    # the vocabulary and the ids
    tk, ids = chain.tokenize(text, 384)
    jtokens, jscores = jtrain_spm_vocab(text, size=384)
    assert tk.tokens == jtokens and np.allclose(tk.scores, jscores)
    jids = np.asarray(JSPMTokenizer(jtokens, jscores).encode(text), np.int32)
    assert np.array_equal(ids, jids)
    toks, half = chain.split(ids, S)
    assert toks.shape == ((half - 1) // S, S + 1)
    assert np.array_equal(toks[:, :-1].reshape(-1), ids[:toks.shape[0] * S])

    # 3 Adam steps from JAX's initial parameters
    jcfg = jllama.LlamaConfig(n_vocab=len(jtokens), **CFG)
    cfg = llama.LlamaConfig(n_vocab=len(tk.tokens), **CFG)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg,
                                 dtype=jnp.float32)
    params = params_from_jax(_wire(jparams), device="cpu")
    jl, tl = [], []
    op = JOptParams(adam=JAdamParams(alpha=3e-3, n_iter=3), past=0,
                    max_no_improvement=0)
    jopt_adam(jax.value_and_grad(_jax_nll(jcfg, toks)), jparams, op,
              lambda it, f: jl.append(f))
    params, f, res, it = chain.train(cfg, torch.from_numpy(toks), params, 3,
                                     callback=lambda i, fi: tl.append(fi))
    assert it == 3 and res.name == "DID_NOT_CONVERGE" and len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]

    # the port's GGUF, read back by the port and by JAX
    path = str(tmp_path / "chain.gguf")
    cfg2, params2, ids2 = chain.save_and_reload(path, cfg, params, tk, text,
                                                ids, "cpu")
    assert np.array_equal(ids2, ids)
    jcfg2, jp2 = jload_gguf_llama(path)
    assert jcfg2 == jcfg
    jtk2 = jfrom_gguf(JGGUFReader(path))
    assert jtk2.tokens == tk.tokens and np.allclose(jtk2.scores, tk.scores)

    def same(port, jax_, name):
        if port is None:
            assert jax_ is None, name
        elif isinstance(port, dict):
            for k in port:
                same(port[k], jax_[k], f"{name}.{k}")
        elif isinstance(port, list):
            for i, (a, b) in enumerate(zip(port, jax_)):
                same(a, b, f"{name}[{i}]")
        else:
            np.testing.assert_array_equal(port.numpy(), np.asarray(b := jax_),
                                          err_msg=name)
            assert port.dtype == torch.float32 and b.dtype == np.float32

    same(params, jp2, "params")
    same(params2, jp2, "reloaded")

    # held-out perplexity of the reloaded weights
    heldout = ids2[half:]
    got = chain.score(cfg2, params2, heldout, chunk=S,
                      formats=[("Q8_0", GType.Q8_0), ("Q4_K", GType.Q4_K)],
                      qa_ab=("Q8_0",))
    jp2 = jax.tree.map(jnp.asarray, jp2)
    ppl_fp, _, n = _jax_ppl(jcfg2, jp2, heldout)
    assert got["fp32"][1] == n
    np.testing.assert_allclose(got["fp32"][0], ppl_fp, rtol=1e-5)
    for name, gt, qa in (("Q8_0", JGType.Q8_0, True),
                         ("Q8_0-noQA", JGType.Q8_0, False),
                         ("Q4_K", JGType.Q4_K, True)):
        want, _, _ = _jax_ppl(jcfg2, jp2, heldout, gt, qa)
        np.testing.assert_allclose(got[name], want, rtol=1e-4, err_msg=name)
    # the chain's dppl column, as the JAX test's bar (tests/test_eval.py:117)
    assert abs(got["Q8_0"] - got["fp32"][0]) < 0.05 * got["fp32"][0]


def test_chain_script_writes_its_table(tmp_path, monkeypatch, capsys):
    """scripts/ppl_chain_torch.py at the tiny size, one seed, two steps, on
    the CPU: the doc carries every row of the JAX script's table, the
    seed's GGUF lands in the temporary directory, and the KV-quality script
    then appends its table from that file. Without a card and without
    --device the scripts raise."""
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    for k, v in (("PPL_SENT", "60"), ("PPL_STEPS", "2"), ("PPL_SEEDS", "0"),
                 ("PPL_SIZE", "tiny"), ("PPL_VOCAB", "300"),
                 ("KVQ_CHUNKS", "2"), ("TMPDIR", str(tmp_path))):
        monkeypatch.setenv(k, v)
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    doc = str(tmp_path / "chain.md")
    ppl, kvq = load("ppl_chain_torch"), load("kv_quality_torch")
    assert ppl.main(["--device", "cpu", "--doc", doc]) == 0
    assert os.path.exists(tmp_path / "ppl_chain_torch_s0.gguf")
    assert kvq.main(["--device", "cpu", "--doc", doc]) == 0
    text = open(doc).read()
    for row in chain.ORDER:
        assert f"| {row} |" in text
    assert "Card: CPU (no card)" in text and "2L/128E/256F" in text
    for name, *_ in __import__(
            "ggmlsharp_tpu_torch.eval.kv_quality",
            fromlist=["CACHES"]).CACHES:
        assert f"| {name} |" in text
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ppl.main(["--doc", doc])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvq.main(["--doc", doc])
