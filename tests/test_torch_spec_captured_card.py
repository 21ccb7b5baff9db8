"""The speculative rounds and the engine's admissions captured on the card
(needs a CUDA device; skips without one): a captured greedy round gives its
eager form's tokens and launches, one graph a (t_eff, d_eff) replayed a
round; a sampled round captures with its generator registered, draws anew
at each replay and advances the generator; a speculative engine (its
rounds and its single and grouped admissions captured) gives its eager
form's tokens; a dead graph collected during a capture does not spoil it.
Imports no JAX: the comparison is with the same functions' eager form
(captured.disabled())."""
import contextlib

import pytest
import torch

from ggmlsharp_tpu_torch import kernels
from ggmlsharp_tpu_torch.models import captured, llama
from ggmlsharp_tpu_torch.models import speculative as spec
from ggmlsharp_tpu_torch.serving import Engine, Request

K = 4
CFG = dict(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_head_kv=4,
           n_layer=2, n_ff=512)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rounds(cfg, p, dev, sampled, eager, n=3):
    """n rounds after an 8-token prompt, draft = target: each round's
    emitted, n_emit and next seed as one host tensor."""
    prompt = torch.arange(3, 11, dtype=torch.int32, device=dev)[None]
    tc, dc = llama.new_cache(cfg, 1, device=dev), \
        llama.new_cache(cfg, 1, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        lg, out = llama.forward(p, cfg, prompt, tc, pos, prefix_bound=64)
        tc.length.copy_(out.length)
        _, out = llama.forward(p, cfg, prompt[:, :-1], dc, pos[:, :-1],
                               prefix_bound=64)
        dc.length.copy_(out.length)
    seed = torch.cat([prompt[:, -1:], lg[:, -1].argmax(-1, keepdim=True)
                      .to(torch.int32)], 1)
    if sampled:
        rnd = spec.make_spec_round_sampled(llama.forward, cfg, llama.forward,
                                           cfg, K)
        gen = torch.Generator(dev).manual_seed(7)
        extra = (gen, torch.full((1,), 0.8, device=dev),
                 torch.zeros(1, dtype=torch.int32, device=dev),
                 torch.full((1,), 0.95, device=dev))
    else:
        rnd = spec.make_spec_round(llama.forward, cfg, llama.forward, cfg, K)
        extra = ()
    outs = []
    with captured.disabled() if eager else contextlib.nullcontext():
        for _ in range(n):
            em, ne, tc2, dc2, seed = rnd(p, p, tc, dc, seed, *extra,
                                         t_eff=64, d_eff=64)
            assert tc2 is tc and dc2 is dc
            outs.append(torch.cat([em, ne[:, None], seed], 1).cpu())
    return outs, extra[0] if sampled else None


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_captured_round_gives_the_eager_round(sampled):
    """Greedy: tokens and launches equal the eager form's. Sampled: the
    round captures with its generator registered (one capture, a replay a
    round), each replay draws anew (the generator advances), and the
    stream equals the eager one from the same seed."""
    dev = _card()
    cfg = llama.LlamaConfig(**CFG)
    p = llama.synthetic_q4_0_params(cfg, seed=1, device=dev)
    res = []
    for eager in (True, False):
        kernels.reset_launches()
        captured.reset_counts()
        outs, gen = _rounds(cfg, p, dev, sampled, eager)
        res.append((outs, dict(kernels.LAUNCHES), dict(captured.COUNTS),
                    None if gen is None else gen.get_state()))
    (oe, le, ce, ge), (oc, lc, cc, gc) = res
    assert ce["captures"] == 0 and cc["captures"] == 1
    assert cc["replays"] == 3
    for a, b in zip(oe, oc):
        assert torch.equal(a, b)
    assert le == lc
    if sampled:
        assert torch.equal(ge, gc)  # both advanced alike


@pytest.mark.cuda
def test_captured_engine_gives_the_eager_tokens():
    """A speculative engine over a flat INT8 cache (a group of 3 padded to 4,
    a prefix, a chunked prompt, sampled requests): the captured form's
    tokens and launches are the eager form's; admissions replay one graph a
    (bucket, total, cached, draft) and a (bucket, G, draft)."""
    dev = _card()
    cfg = llama.LlamaConfig(**CFG)
    p = llama.synthetic_q4_0_params(cfg, seed=1, device=dev)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist()
               for n in (5, 9, 12, 30, 7)]
    res = []
    for eager in (True, False):
        kernels.reset_launches()
        captured.reset_counts()
        with captured.disabled() if eager else contextlib.nullcontext():
            eng = Engine(llama.forward, cfg, p, batch_slots=4, max_len=64,
                         int8_kv=True, prefill_chunk=16, device=dev,
                         draft_forward=llama.forward, draft_params=p,
                         spec_k=K)
            assert eng.cache.is_flat and eng.cache.int8
            pid = eng.register_prefix(prompts[4][:4])
            for i, pr in enumerate(prompts):
                eng.submit(Request(id=i, prompt=pr, max_new_tokens=10,
                                   prefix_id=pid if i == 4 else None,
                                   temperature=0.8 if i == 1 else 0.0))
            out = {r.id: r.out_tokens for r in eng.run()}
        res.append((out, dict(kernels.LAUNCHES), dict(captured.COUNTS)))
    (oe, le, ce), (oc, lc, cc) = res
    assert oe == oc and le == lc
    assert ce["captures"] == 0 and cc["captures"] >= 3
    assert all(len(t) == 10 for t in oc.values())


@pytest.mark.cuda
def test_a_dead_graph_collected_during_a_capture_does_not_spoil_it():
    """A captured step dropped in a reference cycle (as an engine drops its
    CapturedSteps) is garbage; a capture that makes many Python objects
    (with the collector on, it would collect the dead graph inside the
    capture, where CUDA refuses to destroy a graph, and the capture would
    fail) still captures, and the dead graph goes at the next
    collection."""
    import gc

    dev = _card()

    class Holder:  # a cycle, as Engine -> CapturedStep -> bound method
        def __init__(self):
            self.step = captured.CapturedStep(self.body)

        def body(self, x):
            return x * 2

    h = Holder()
    h.step(torch.ones(8, device=dev))
    del h  # a dead cycle holding a captured graph
    calls = []

    def churn(x):
        calls.append(1)
        if len(calls) == 2:  # the capture, after the warm-up
            junk = [[i] for i in range(200_000)]  # many collections' worth
            del junk
        return x + 1

    y = captured.CapturedStep(churn)(torch.zeros(4, device=dev))
    assert float(y.sum()) == 4.0 and len(calls) == 2
    gc.collect()
