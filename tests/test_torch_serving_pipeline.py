"""The engine's window pipelining (GGML_TPU_SERVE_PIPELINE) against the JAX
engine's ``_multi_tick`` on the CPU: the same requests (waves of two that
drain fully inside one window, and one request that stops early at its
eos) at depths 1 and 4 give the same tokens and the same ``stats()``
counts of ticks, emitted tokens, prefill dispatches and admissions behind
a window. The model is test_torch_serving's tiny float GPT-2 over the
head-major INT8 cache, whose tokens the two engines give alike.
"""
import pytest

from ggmlsharp_tpu.serving import Engine as JEngine
from ggmlsharp_tpu.serving import Request as JRequest
from ggmlsharp_tpu_torch.serving import Engine, Request
from test_torch_serving import _float_models

PROMPTS = [[5, 17, 33, 2], [7, 1, 2, 3, 4, 5, 6, 8, 9], [11, 4], [3, 3, 3],
           [9, 8, 7, 6, 5]]
N_NEW, EOS_REQ = 4, 3  # request 3 stops at the 2nd token it would make
STATS = ("ticks", "tokens_emitted", "prefill_dispatches",
         "speculative_admissions")


@pytest.fixture(scope="module")
def gpt2_models():
    return _float_models("gpt2")


def _run(engine, request, eos=None):
    for i, p in enumerate(PROMPTS):
        engine.submit(request(id=i, prompt=list(p), max_new_tokens=N_NEW,
                              eos_id=eos if i == EOS_REQ else None))
    out = {r.id: r.out_tokens for r in engine.run()}
    return out, {k: engine.stats()[k] for k in STATS}


def _port(gpt2_models, eos=None):
    *_, tmod, tcfg, tp = gpt2_models
    return _run(Engine(tmod.forward, tcfg, tp, batch_slots=2, int8_kv=True,
                       max_len=64, multi_step=8, device="cpu"), Request, eos)


@pytest.fixture(scope="module")
def eos(gpt2_models):
    """The token request EOS_REQ makes second (the port's run without an
    eos, depth 1), so that it stops inside its window."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GGML_TPU_SERVE_PIPELINE", "1")
        return _port(gpt2_models)[0][EOS_REQ][1]


@pytest.mark.parametrize("depth", [1, 4])
def test_pipelined_windows_match_jax_engine(depth, monkeypatch, gpt2_models,
                                            eos):
    monkeypatch.setenv("GGML_TPU_SERVE_PIPELINE", str(depth))
    jmod, jcfg, jp, *_ = gpt2_models
    want, want_st = _run(JEngine(jmod.forward, jcfg, jp, batch_slots=2,
                                 int8_kv=True, max_len=64, multi_step=8),
                         JRequest, eos)
    got, got_st = _port(gpt2_models, eos)
    assert got == want
    assert got_st == want_st
    assert len(got[EOS_REQ]) <= 2 and got[EOS_REQ][-1] == eos
    assert got_st["speculative_admissions"] > 0


def test_depth_4_dispatches_the_waves_before_the_first_fetch(
        monkeypatch, gpt2_models):
    """At depth 1 each window is fetched before the next is dispatched; at
    depth 4 the three waves' windows are dispatched in one tick, then
    drained in order. The tokens are the same."""
    *_, tmod, tcfg, tp = gpt2_models
    runs = {}
    for depth in (1, 4):
        monkeypatch.setenv("GGML_TPU_SERVE_PIPELINE", str(depth))
        eng = Engine(tmod.forward, tcfg, tp, batch_slots=2, int8_kv=True,
                     max_len=64, multi_step=8, device="cpu")
        log = []
        for name, mark in (("_dispatch_window", "d"), ("_drain_window", "f")):
            def logged(*a, _f=getattr(eng, name), _m=mark):
                log.append(_m)
                return _f(*a)
            monkeypatch.setattr(eng, name, logged)
        runs[depth] = (_run(eng, Request), "".join(log))
    assert runs[1][0] == runs[4][0]
    assert runs[1][1] == "df" * 3
    assert runs[4][1] == "dddfff"
