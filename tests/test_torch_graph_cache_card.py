"""The graph cache on the card (needs a CUDA device; skips without one):
a second generate with a new cache of one spec makes no capture and gives
the first call's tokens, launches and cache rows; a home cache reused with
the rows of a longer earlier call past its length gives the tokens and
rows of a fresh one, bit for bit (every attention route masks them: the
einsum route and the flash prefill over a head-major bf16 cache,
attn_decode's split-K merge over a flat INT8 cache); a sampled generate
leaves its generator as the eager form does; a second speculative call
makes no capture. Imports no JAX: the comparison is with the eager form
(captured.disabled()) and with a fresh graph cache (captured.clear())."""
import contextlib

import pytest
import torch

from ggmlsharp_tpu_torch import kernels
from ggmlsharp_tpu_torch.models import captured, llama, sampling
from ggmlsharp_tpu_torch.models.speculative import speculative_generate

CFG = dict(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_head_kv=2,
           n_layer=2, n_ff=512)  # E_kv 128: an INT8 cache is flat
N_NEW = 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dev):
    cfg = llama.LlamaConfig(**CFG)
    return cfg, llama.synthetic_q4_0_params(cfg, seed=1, device=dev)


def _prompt(dev, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (1, n), generator=g,
                         dtype=torch.int32).to(dev)


def _run(cfg, p, prompt, int8, eager=False, **kw):
    """One generate with a fresh cache: tokens, the cache, launches and
    captured.COUNTS."""
    cache = llama.new_cache(cfg, 1, int8=int8)
    kernels.reset_launches()
    captured.reset_counts()
    with captured.disabled() if eager else contextlib.nullcontext():
        toks, out = sampling.generate(llama.forward, cfg, p, prompt, cache,
                                      N_NEW, **kw)
    assert out is cache
    return toks.cpu(), cache, dict(kernels.LAUNCHES), dict(captured.COUNTS)


def _same_rows(a, b):
    n = int(a.length.max())
    assert torch.equal(a.length, b.length)
    dim = 1 if a.is_flat else 2
    for x, y in zip(captured.buffers(a)[1:], captured.buffers(b)[1:]):
        assert torch.equal(x.narrow(dim, 0, n), y.narrow(dim, 0, n))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_second_call_captures_nothing_and_stale_rows_are_masked(int8):
    dev = _card()
    cfg, p = _model(dev)
    assert llama.new_cache(cfg, 1, int8=int8).is_flat == int8
    long, short = _prompt(dev, 40, 1), _prompt(dev, 12, 2)
    captured.clear()
    first = _run(cfg, p, long, int8)
    assert first[3]["captures"] == 2  # the prefill and the step
    again = _run(cfg, p, long, int8)
    assert again[3]["captures"] == 0 and again[3]["replays"] == N_NEW + 1
    assert torch.equal(first[0], again[0]) and first[2] == again[2]
    _same_rows(first[1], again[1])
    reused = _run(cfg, p, short, int8)  # rows 12.. of the home are stale
    assert reused[3]["captures"] == 1  # the new prompt length's prefill
    captured.clear()
    fresh = _run(cfg, p, short, int8)
    eager = _run(cfg, p, short, int8, eager=True)
    for other in (fresh, eager):
        assert torch.equal(reused[0], other[0]) and reused[2] == other[2]
        _same_rows(reused[1], other[1])


@pytest.mark.cuda
def test_sampled_generate_leaves_the_generator_as_eager():
    dev = _card()
    cfg, p = _model(dev)
    prompt = _prompt(dev, 10, 3)
    out = []
    for eager in (True, False, False):
        gen = torch.Generator(dev).manual_seed(5)
        toks, *_ = _run(cfg, p, prompt, False, eager=eager,
                        temperature=0.8, top_k=40, rng=gen)
        out.append((toks, gen.get_state()))
    for toks, state in out[1:]:
        assert torch.equal(toks, out[0][0]) and torch.equal(state, out[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_second_speculative_call_captures_nothing(temperature):
    dev = _card()
    cfg, p = _model(dev)
    prompt = _prompt(dev, 16, 4)
    captured.clear()
    out = []
    for eager in (False, False, True):
        gen = torch.Generator(dev).manual_seed(9)
        captured.reset_counts()
        with captured.disabled() if eager else contextlib.nullcontext():
            toks, rate = speculative_generate(
                llama.forward, cfg, p, llama.forward, cfg, p, prompt,
                llama.new_cache(cfg, 1), llama.new_cache(cfg, 1), 20, k=4,
                temperature=temperature, rng=gen)
        out.append((toks.cpu(), rate, gen.get_state(),
                    dict(captured.COUNTS)))
    assert out[0][3]["captures"] >= 3  # two prefills and a round
    assert out[1][3]["captures"] == 0
    for toks, rate, state, _ in out[1:]:
        assert torch.equal(toks, out[0][0]) and rate == out[0][1]
        assert torch.equal(state, out[0][2])
