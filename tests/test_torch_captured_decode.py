"""The captured decode step (models.captured) on the CPU, against the JAX
package's decode loop and against the port's own eager run.

On the CPU a CapturedStep runs its function eagerly through the same static
input and output buffers that its graph reads and writes on the card: the
protocol (inputs copied in, outputs read back from static buffers, the
cache's length written in place) is what these tests hold. Per model
(the small llama per-op over the flat INT8 cache, a tiny GPT-2 over its
flat and head-major caches, a GPT-J), with inputs made from a numpy seed:

  * sampling.generate through the protocol gives the JAX package's greedy
    tokens (jsampling.generate's loop) up to a near tie, and
    make_decode_fns' step gives logits within the bar of the existing test
    file of that model, bit-equal to the port's eager run
    (captured.disabled());
  * each model's decode step, and the engine's step with ``active``, make
    no host sync (test_torch_lbfgs_jit._NoHostSync), so they can be
    captured;
  * a replay adds the launches its capture counted, and the warm-up and the
    capture add none (a stub graph stands in for CUDA's);
  * a per-stream buffer (kernels/_sync.py, attn_decode's counters) is never
    made inside a capture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.models import gptj as jgptj
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu_torch.kernels import _build, _sync, attn_decode
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import captured, gptj, llama, sampling
from ggmlsharp_tpu_torch.serving import Engine
from test_torch_gptj import CFG as GPTJ_CFG
from test_torch_gptj import _trees as gptj_trees
from test_torch_lbfgs_jit import _NoHostSync
from test_torch_llama import CFG as LLAMA_CFG
from test_torch_llama import to_port_tree
from test_torch_serving import _float_models

N_NEW = 5


@pytest.fixture(scope="module")
def llama_models():
    """test_torch_serving's small llama (GQA, E_kv 128: the flat INT8
    cache), Q4_0, in both packages."""
    jcfg = jllama.LlamaConfig(**LLAMA_CFG)
    raw = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    jq = jllama.quantize_params(raw, JGType.Q4_0, swar=False)
    tq = llama.params_from_jax(to_port_tree(jq), device="cpu")
    return jcfg, jq, llama.LlamaConfig(**LLAMA_CFG), tq


@pytest.fixture(autouse=True)
def _exact(monkeypatch):
    """Both packages in mm_dot "f32" (JAX's decode-attention kernel in its
    exact mode, the port's products exact), and the Q8_0 activation round
    trip on in both."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot("f32")
    monkeypatch.setattr(get_config(), "quantize_activations", True)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1")
    yield
    jkcfg.set_mm_dot(prev)


def _case(name, llama_models):
    """(JAX forward, cfg, params, new cache; port forward, cfg, params, new
    cache; the logit bar of the model's test file)."""
    if name == "llama_flat_int8":  # test_torch_serving's bar with Q8 acts
        jcfg, jq, tcfg, tq = llama_models
        return (jllama.forward, jcfg, jq,
                lambda: jllama.new_cache(jcfg, 1, int8=True),
                llama.forward, tcfg, tq,
                lambda: llama.new_cache(tcfg, 1, int8=True, device="cpu"),
                2e-2)
    if name.startswith("gpt2"):  # test_torch_gpt2's weight-only bar
        jmod, jcfg, jp, tmod, tcfg, tp = _float_models("gpt2")
        flat = name == "gpt2_flat"
        kw = {} if flat else {"int8": True}
        return (jmod.forward, jcfg, jp, lambda: jmod.new_cache(jcfg, 1, **kw),
                tmod.forward, tcfg, tp,
                lambda: tmod.new_cache(tcfg, 1, device="cpu", **kw), 2e-4)
    jp, tp = gptj_trees("f", "float32")  # test_torch_gptj's f32 bar
    jcfg, tcfg = jgptj.GPTJConfig(**GPTJ_CFG), gptj.GPTJConfig(**GPTJ_CFG)
    return (jgptj.forward, jcfg, jp,
            lambda: jgptj.new_cache(jcfg, 1, dtype=jnp.float32),
            gptj.forward, tcfg, tp,
            lambda: gptj.new_cache(tcfg, 1, dtype=torch.float32,
                                   device="cpu"), 2e-5)


def _prompt(n_vocab, n=8, seed=3):
    return np.random.default_rng(seed).integers(
        0, n_vocab, (1, n)).astype(np.int32)


def _port_rows(fwd, cfg, params, cache, prompt, toks):
    """make_decode_fns' prefill and steps fed ``toks``: the logits rows."""
    prefill, step = sampling.make_decode_fns(fwd, cfg)
    cur = prompt.shape[1]
    with torch.inference_mode():
        lg, cache = prefill(params, torch.from_numpy(prompt), cache,
                            t_eff=sampling.length_bucket(cur, cache.max_len))
        rows = [lg]
        for i in range(toks.shape[1]):
            cur += 1
            lg, cache = step(params, torch.from_numpy(toks[:, i:i + 1].copy()),
                             cache, t_eff=sampling.length_bucket(
                                 cur, cache.max_len))
            rows.append(lg)
    return torch.stack(rows).numpy(), cache


def _jax_generate(jfwd, jcfg, jp, cache, prompt):
    """jsampling.generate's greedy loop (its make_decode_fns and
    sample_token, its buckets), keeping the logits that chose each token:
    (tokens [1, N_NEW], logits [N_NEW, 1, V])."""
    pre, step = jsampling.make_decode_fns(jfwd, jcfg)
    cur = prompt.shape[1]
    lg, cache = pre(jp, jnp.asarray(prompt), cache,
                    t_eff=jsampling.length_bucket(cur, cache.max_len))
    toks, rows = [], []
    for _ in range(N_NEW):
        tok = jsampling.sample_token(lg, None)
        toks.append(np.asarray(tok))
        rows.append(np.asarray(lg))
        cur += 1
        lg, cache = step(jp, tok, cache,
                         t_eff=jsampling.length_bucket(cur, cache.max_len))
    return np.concatenate(toks, 1), np.stack(rows)


@pytest.mark.parametrize("name", ["llama_flat_int8", "gpt2_flat",
                                  "gpt2_head_major", "gptj"])
def test_captured_protocol_matches_jax_and_eager(name, llama_models):
    """generate's tokens through the protocol: JAX's up to a near tie;
    make_decode_fns' logits along JAX's tokens: within the model's bar of
    JAX's, and bit-equal to the eager run's."""
    (jfwd, jcfg, jp, jcache, tfwd, tcfg, tp, tcache, tol) = _case(
        name, llama_models)
    prompt = _prompt(tcfg.n_vocab)
    jtoks, jrows = _jax_generate(jfwd, jcfg, jp, jcache(), prompt)
    captured.reset_counts()
    toks, cache = sampling.generate(tfwd, tcfg, tp, torch.from_numpy(prompt),
                                    tcache(), N_NEW)
    assert int(cache.length[0]) == prompt.shape[1] + N_NEW
    assert captured.COUNTS["captures"] == 0  # no graph on the CPU
    rows, c = _port_rows(tfwd, tcfg, tp, tcache(), prompt, jtoks[:, :-1])
    assert int(c.length[0]) == prompt.shape[1] + N_NEW - 1
    with captured.disabled():
        erows, _ = _port_rows(tfwd, tcfg, tp, tcache(), prompt,
                              jtoks[:, :-1])
    np.testing.assert_array_equal(rows, erows)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=tol)
    for i, (got, want) in enumerate(zip(toks[0].tolist(), jtoks[0])):
        if got != want:  # a near tie may flip; the runs part there
            top2 = np.sort(jrows[i, 0])[-2:]
            assert top2[1] - top2[0] <= 2 * tol, (i, got, want)
            break
        assert rows[i, 0].argmax() == got


def _fused_case(name):
    """The card's fused decode routes as the port runs them on the CPU
    (their kernels' plain versions): llama's whole-block route over a flat
    float cache, GPT-2 Q8_0's over its flat cache."""
    from ggmlsharp_tpu_torch.models import gpt2

    if name == "llama_layer_fused":
        cfg = llama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4,
                                n_head_kv=4, n_layer=2, n_ff=512)
        p = llama.synthetic_q4_0_params(cfg, seed=1, device="cpu",
                                        mlp_fused=True, layer_fused=True)
        return llama.forward, cfg, p, lambda: llama.new_cache(
            cfg, 1, flat=True, device="cpu")
    cfg = gpt2.GPT2Config(n_vocab=512, n_ctx=64, n_embd=256, n_head=4,
                          n_layer=2)
    p = gpt2.synthetic_q8_0_params(cfg, seed=1, device="cpu")
    return gpt2.forward, cfg, p, lambda: gpt2.new_cache(cfg, 1, device="cpu")


@pytest.mark.parametrize("name", ["llama_flat_int8", "gpt2_flat",
                                  "gpt2_head_major", "gptj",
                                  "llama_layer_fused", "gpt2_q8_flat"])
def test_decode_step_makes_no_host_sync(name, llama_models):
    """The step a CapturedStep captures (the forward, the cache's length
    written in place) reads nothing back to the host."""
    if name in ("llama_layer_fused", "gpt2_q8_flat"):
        tfwd, tcfg, tp, tcache = _fused_case(name)
    else:
        *_, tfwd, tcfg, tp, tcache, _ = _case(name, llama_models)
    cache = tcache()
    prefill, _ = sampling.make_decode_fns(tfwd, tcfg)
    with torch.inference_mode():
        lg, cache = prefill(tp, torch.from_numpy(_prompt(tcfg.n_vocab)),
                            cache, t_eff=cache.max_len)
        length = cache.length
        step = sampling._StepGraphs(tfwd, tcfg, greedy=True)(tp, cache)
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
        with _NoHostSync():
            for _ in range(2):
                tok = step(tok, t_eff=cache.max_len)
    assert cache.length is length and int(length[0]) == 10


def test_engine_step_makes_no_host_sync(llama_models):
    _, _, tcfg, tq = llama_models
    eng = Engine(llama.forward, tcfg, tq, batch_slots=2, int8_kv=True,
                 max_len=64, device="cpu")
    length = eng.cache.length
    length.copy_(torch.tensor([3, 5], dtype=torch.int32))
    tokens = torch.tensor([[7], [9]], dtype=torch.int32)
    active = torch.tensor([True, False])
    with torch.no_grad(), _NoHostSync():
        logits, nxt, lp = eng._step(tokens, active, 64, want_lps=True)
        eng._step(nxt, active, 64)
    assert eng.cache.length is length and length.tolist() == [5, 5]
    assert logits.shape == (2, tcfg.n_vocab) and nxt.shape == (2, 1)
    assert bool((lp <= 0).all())


# --- launch accounting ----------------------------------------------------

class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: replay() runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stub_cuda(monkeypatch):
    """torch.cuda's capture calls as no-ops on the CPU: the capture context
    runs its body (here eagerly), the stream calls do nothing."""
    import contextlib

    class _Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(captured, "capture_stream", lambda d: _Stream())


def test_replay_adds_the_captured_launches(monkeypatch):
    _stub_cuda(monkeypatch)
    geom = ("matmul_q4_0", 64, 256, 4, 2, 1)

    def fn(x, t_eff):  # counts as three kernel launches would
        _build.check("matmul_q4_0", 0, geometry=geom[1:])
        _build.check("matmul_q4_0", 0, geometry=geom[1:])
        _build.check("attn_decode", 0)
        return x * t_eff

    _build.reset_launches()
    state = torch.zeros(3)
    cs = captured.CapturedStep(fn, state=(state,))
    x = torch.ones(3)
    g = captured._Graph((x,))
    g.inputs[0].copy_(x)
    cs._capture(g, {"t_eff": 2})  # the warm-up, then the capture
    assert _build.LAUNCHES["matmul_q4_0"] == 0
    assert _build.LAUNCHES["attn_decode"] == 0
    assert not _build.GEOMETRY_LAUNCHES
    assert g.launches == ({"matmul_q4_0": 2, "attn_decode": 1}, {geom: 2})
    for n in (1, 2):
        cs._replay(g)
        assert _build.LAUNCHES["matmul_q4_0"] == 2 * n
        assert _build.LAUNCHES["attn_decode"] == n
        assert _build.GEOMETRY_LAUNCHES == {geom: 2 * n}
    assert g.graph.replays == 2
    _build.reset_launches()


def test_warm_up_state_is_restored_before_capture(monkeypatch):
    """The warm-up's update of ``state`` is undone, so the capture (and the
    first replay) starts from the caller's state."""
    _stub_cuda(monkeypatch)
    length = torch.tensor([4], dtype=torch.int32)
    seen = []

    def fn(x):
        seen.append(int(length[0]))
        length.copy_(length + 1)
        return x + 1

    cs = captured.CapturedStep(fn, state=(length,))
    g = captured._Graph((torch.zeros(1),))
    cs._capture(g, {})
    assert seen == [4, 4]  # warm-up and capture both see the caller's 4


def test_disabled_runs_the_function_on_its_arguments():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    cs = captured.CapturedStep(fn)
    x = torch.arange(3.0)
    with captured.disabled():
        assert captured.is_disabled()
        y = cs(x)
    assert not captured.is_disabled()
    assert calls[0] is x and torch.equal(y, x * 2)
    out = cs(x)  # the protocol: the input copied into its static buffer
    assert calls[1] is not x and torch.equal(calls[1], x)
    assert cs(x + 1) is out and torch.equal(out, (x + 1) * 2)


# --- per-stream buffers never made inside a capture -----------------------

@pytest.mark.parametrize("which", ["sync", "exchange", "attn_counter"])
def test_per_stream_buffer_refused_inside_capture(which, monkeypatch):
    dev = torch.device("cpu")
    monkeypatch.setattr(_sync, "_SYNC", {})
    monkeypatch.setattr(_sync, "_XCH", {})
    monkeypatch.setattr(attn_decode, "_COUNTERS", {})
    monkeypatch.setattr(attn_decode, "device_sms", lambda d: 132)
    make = {"sync": lambda: _sync.sync_buffer(dev, 0x51),
            "exchange": lambda: _sync.exchange_buffer(dev, 0x51, 64),
            "attn_counter": lambda: attn_decode._counter(dev, 0x51, 8)}[which]
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    with pytest.raises(RuntimeError, match="0x51"):
        make()
    capturing[0] = False
    buf = make()  # made and zeroed outside the capture
    assert not bool(buf.any())
    capturing[0] = True
    assert make() is buf  # an existing buffer is handed out in a capture
