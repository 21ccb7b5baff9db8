"""The in-graph length-bucket switch on the card (needs a CUDA device;
skips without one): make_decode_fns' step, make_greedy_step and the greedy
and sampled speculative rounds at ``t_eff=None`` replay ONE parent graph
for a run that crosses every bucket of a 1024-row cache (256, 512, 1024),
with no host sync (torch.cuda.set_sync_debug_mode("error")), and give the
tokens of the t_eff-passing forms (one graph a bucket); the sampled round
draws what the t_eff-passing round draws from the same generator state and
advances the generator alike; the selector kernel gives its plain
version's index; the older toolkits' parent (a chain of if nodes) gives
the switch node's tokens. Imports no JAX: the comparison is with the same
functions' other forms."""
import pytest
import torch

from ggmlsharp_tpu_torch import kernels
from ggmlsharp_tpu_torch.kernels import graph_switch as gs
from ggmlsharp_tpu_torch.models import captured, llama, sampling
from ggmlsharp_tpu_torch.models import speculative as spec
from ggmlsharp_tpu_torch.models.common import _chunk_buckets

T = 1024
CFG = dict(n_vocab=256, n_ctx=T, n_embd=256, n_head=4, n_head_kv=4,
           n_layer=2, n_ff=512)
PROMPT = 250
K = 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dev):
    cfg = llama.LlamaConfig(**CFG)
    return cfg, llama.synthetic_q4_0_params(cfg, seed=1, device=dev)


def _prompt(dev):
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, 256, (1, PROMPT), generator=g,
                         dtype=torch.int32).to(dev)


@pytest.mark.cuda
def test_selector_kernel_gives_the_plain_index():
    dev = _card()
    g = torch.Generator(dev).manual_seed(0)
    for B in (1, 8):
        for add in (1, 3, 300):
            ln = torch.randint(0, T - add, (B,), generator=g, device=dev,
                               dtype=torch.int32)
            b = gs.bucket_bound("t_eff", ln, add, _chunk_buckets(T))
            two = (b, b._replace(name="d_eff", length=ln.flip(0)))
            for bounds in ((b,), two):
                assert int(gs.select(bounds)) == int(
                    gs.select_index(bounds))


def _steps(cfg, p, dev, greedy, switched):
    """300 steps from a 250-token prompt (lims 251..550), the switched form
    under the sync check from its second step: the tokens, launches and
    captured.COUNTS of the run."""
    prompt = _prompt(dev)
    captured.clear()
    prefill, step = sampling.make_decode_fns(llama.forward, cfg)
    if greedy:
        step = sampling.make_greedy_step(llama.forward, cfg)
    cache = llama.new_cache(cfg, 1, device=dev)
    out = torch.empty((1, 300), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        lg, cache = prefill(p, prompt, cache, t_eff=None if switched
                            else sampling.length_bucket(PROMPT, T))
        tok = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        kernels.reset_launches()
        captured.reset_counts()
        for i in range(300):
            if switched and i == 1:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                t_eff = None if switched else sampling.length_bucket(
                    PROMPT + i + 1, T)
                y, _ = step(p, tok, cache, t_eff=t_eff)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            tok = y if greedy else torch.argmax(
                y, -1, keepdim=True).to(torch.int32)
            out[:, i:i + 1] = tok
    torch.cuda.synchronize()
    return out.cpu(), dict(kernels.LAUNCHES), dict(captured.COUNTS)


@pytest.mark.cuda
@pytest.mark.parametrize("greedy", [False, True])
def test_switched_step_replays_one_graph(greedy):
    """300 steps from a 250-token prompt (lims 251..550): one capture (three
    bodies), a replay a step, no host sync, the t_eff-passing form's
    tokens and launches (and one selector launch a step)."""
    dev = _card()
    cfg, p = _model(dev)
    (ob, lb, cb), (os_, ls, cs) = (_steps(cfg, p, dev, greedy, switched)
                                   for switched in (False, True))
    assert torch.equal(ob, os_)
    assert ls.pop("graph_switch") == 300 and lb.pop("graph_switch") == 0
    assert lb == ls
    assert cb["captures"] == 3 and cs["captures"] == 1
    assert cs["switch_bodies"] == 3 and cs["replays"] == 300
    assert captured.SWITCH["design"] in ("switch", "if_chain")


@pytest.mark.cuda
def test_if_chain_parent_gives_the_switch_parents_tokens():
    """The older toolkits' parent, a chain of if nodes (built here with
    -DGS_SWITCH=0), against the switch node's: the same 300 steps' tokens
    and launches, one capture of three bodies, no host sync."""
    dev = _card()
    cfg, p = _model(dev)
    want = _steps(cfg, p, dev, False, True)
    assert captured.SWITCH["design"] == gs.design() == "switch"
    gs.set_design("if_chain")
    try:
        got = _steps(cfg, p, dev, False, True)
        assert captured.SWITCH["design"] == gs.design() == "if_chain"
    finally:
        captured.clear()
        gs.set_design()
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert got[2]["captures"] == 1 and got[2]["switch_bodies"] == 3


def _rounds(cfg, p, dev, sampled, switched, n):
    prompt = _prompt(dev)
    tc = llama.new_cache(cfg, 1, device=dev)
    dc = llama.new_cache(cfg, 1, device=dev)
    pos = torch.arange(PROMPT, dtype=torch.int32, device=dev)[None]
    gen = torch.Generator(dev).manual_seed(7)
    with torch.inference_mode():
        lg, o = llama.forward(p, cfg, prompt, tc, pos, prefix_bound=256)
        tc.length.copy_(o.length)
        _, o = llama.forward(p, cfg, prompt[:, :-1], dc, pos[:, :-1],
                             prefix_bound=256)
        dc.length.copy_(o.length)
        seed = torch.cat([prompt[:, -1:], torch.argmax(
            lg[:, -1], -1, keepdim=True).to(torch.int32)], 1)
        if sampled:
            rnd = spec.make_spec_round_sampled(llama.forward, cfg,
                                               llama.forward, cfg, K)
            extra = (gen, torch.full((1,), 0.8, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.full((1,), 0.95, device=dev))
        else:
            rnd = spec.make_spec_round(llama.forward, cfg, llama.forward,
                                       cfg, K)
            extra = ()
        outs, h = [], PROMPT
        for _ in range(n):
            kw = {} if switched else dict(
                t_eff=sampling.length_bucket(h + K + 1, T),
                d_eff=sampling.length_bucket(h + K, T))
            em, ne, _, _, seed = rnd(p, p, tc, dc, seed, *extra, **kw)
            seed = seed.clone()
            outs.append(torch.cat([em, ne[:, None], seed], 1).cpu())
            h += int(outs[-1][0, K + 1])
    return outs, h, gen.get_state()


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_switched_round_gives_the_bucketed_round(sampled):
    """Rounds from a 250-token prompt at t_eff = d_eff = None: one capture
    (nine bodies), the t_eff-passing rounds' tokens, counts and seeds; a
    sampled round draws what the t_eff-passing one draws and leaves the
    generator where it leaves it."""
    dev = _card()
    cfg, p = _model(dev)
    res = []
    for switched in (False, True):
        captured.reset_counts()
        res.append((*_rounds(cfg, p, dev, sampled, switched, 12),
                    dict(captured.COUNTS)))
    (ob, hb, gb, cb), (os_, hs, gs_, cs) = res
    assert hb == hs and hb > 256
    for a, b in zip(ob, os_):
        assert torch.equal(a, b)
    assert torch.equal(gb, gs_)
    assert cs["captures"] == 1 and cs["switch_bodies"] == 9
    assert cs["replays"] == 12
