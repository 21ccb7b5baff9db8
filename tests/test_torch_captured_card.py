"""The captured decode step on the card (needs a CUDA device; skips without
one): a step that cannot be captured raises, naming the cause, and never
runs eagerly in its place; a captured greedy decode gives its eager form's
tokens and launches. Imports no JAX: the comparison is with the same
function's eager form (captured.disabled())."""
import pytest
import torch

from ggmlsharp_tpu_torch import kernels
from ggmlsharp_tpu_torch.kernels import _sync
from ggmlsharp_tpu_torch.models import captured, llama, sampling


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_capture_failure_raises_and_never_runs_eagerly():
    dev = _card()
    calls = []

    def synced(x):
        calls.append(1)
        return x * float(x.sum())  # a host read inside the step

    with pytest.raises(RuntimeError, match="could not be captured"):
        captured.CapturedStep(synced)(torch.ones(4, device=dev))
    assert len(calls) == 2  # the warm-up and the capture, no eager run
    assert float((torch.ones(4, device=dev) * 2).sum()) == 8.0


@pytest.mark.cuda
def test_sync_buffer_refused_inside_a_capture():
    dev = _card()
    side = torch.cuda.Stream(dev)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            _sync.sync_buffer(dev, side.cuda_stream)


@pytest.mark.cuda
def test_captured_generate_gives_the_eager_tokens_and_launches():
    dev = _card()
    cfg = llama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4,
                            n_head_kv=4, n_layer=2, n_ff=512)
    p = llama.synthetic_q4_0_params(cfg, seed=1, device=dev)
    prompt = torch.arange(3, 11, dtype=torch.int32, device=dev)[None]
    captured.clear()  # this tree's prefill and step not yet captured
    out = []
    for eager in (True, False):
        kernels.reset_launches()
        captured.reset_counts()
        if eager:
            with captured.disabled():
                toks, _ = sampling.generate(llama.forward, cfg, p, prompt,
                                            llama.new_cache(cfg, 1), 6)
        else:
            toks, _ = sampling.generate(llama.forward, cfg, p, prompt,
                                        llama.new_cache(cfg, 1), 6)
        out.append((toks.cpu(), dict(kernels.LAUNCHES),
                    dict(captured.COUNTS)))
    (te, le, ce), (tc, lc, cc) = out
    assert torch.equal(te, tc) and le == lc
    # the prefill's graph and the step's, replayed once and 6 times
    assert ce["captures"] == 0 and cc["captures"] == 2
    assert cc["replays"] == 7
