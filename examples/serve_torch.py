"""Continuous-batching serving with the PyTorch/CUDA port: a mixed workload
through the Engine (counterpart of examples/serve.py).

    python examples/serve_torch.py [--slots 4] [--requests 12] [--int8-kv] \
        [--draft] [--prefix] [--top-p 0.9] [--penalty 1.3] [--stream] \
        [--device cuda]

GPT-2 124M with random Q8_0 weights (the tokens mean nothing). Even
requests are greedy, odd ones sample (temperature 0.7, top-k 40).
--draft: speculative continuous batching: a second, differently seeded
model drafts k tokens a tick and the target verifies them in one forward;
greedy requests get the target's own greedy tokens, sampled ones ride
rejection sampling (distributed as the target alone). --prefix: register a
shared system prompt once and reuse its KV across requests. --top-p /
--penalty exercise the nucleus / repetition-penalty samplers (the penalty
is off under --draft, which refuses it); --stream prints each token from
the on_token callback as it lands. Runs on the card unless --device cpu.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

PREFIX = [50, 51, 52, 53, 54, 55]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--draft", action="store_true",
                    help="speculative decoding (greedy-exact)")
    ap.add_argument("--prefix", action="store_true",
                    help="share a cached system-prompt prefix")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--penalty", type=float, default=1.0,
                    help="repetition penalty over the last 64 tokens")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens from the on_token callback")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def model(dev, seed):
    """GPT-2 124M, random bf16 weights from ``seed``, Q8_0 on ``dev``."""
    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.models import gpt2

    cfg = gpt2.GPT2_124M
    params = gpt2.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                              device=dev, dtype=torch.bfloat16)
    return cfg, gpt2.quantize_params(params, GType.Q8_0)


def requests(args, pid):
    """The workload: request i has a prompt of 1 + i % 7 tokens (after the
    shared prefix with --prefix) and 16 + 8 * (i % 3) new tokens."""
    from ggmlsharp_tpu_torch.serving import Request

    return [Request(
        id=i,
        prompt=(PREFIX if pid is not None else []) + list(range(1, 2 + i % 7)),
        max_new_tokens=16 + 8 * (i % 3),
        temperature=0.7 if i % 2 else 0.0,
        top_k=40 if i % 2 else 0,
        top_p=args.top_p,
        repeat_penalty=1.0 if args.draft else args.penalty,
        prefix_id=pid,
        on_token=(lambda r, t: print(f"  [stream] req {r.id} -> {t}"))
        if args.stream else None) for i in range(args.requests)]


def serve(args):
    """Build the engine, submit the workload, run it. Returns (engine,
    params, finished requests, seconds)."""
    import torch

    from ggmlsharp_tpu_torch import resolve_device
    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.serving import Engine

    dev = resolve_device(args.device)
    cfg, params = model(dev, 0)
    spec = {}
    if args.draft:
        _, draft = model(dev, 9)
        spec = dict(draft_forward=gpt2.forward, draft_cfg=cfg,
                    draft_params=draft, spec_k=4)
    eng = Engine(gpt2.forward, cfg, params, batch_slots=args.slots,
                 cache_dtype=torch.bfloat16, int8_kv=args.int8_kv,
                 device=dev, **spec)
    pid = eng.register_prefix(PREFIX) if args.prefix else None
    for req in requests(args, pid):
        eng.submit(req)
    t0 = time.time()
    results = eng.run()
    return eng, params, results, time.time() - t0


def main(argv=None):
    args = parse(argv)
    eng, _, results, dt = serve(args)
    total = sum(len(r.out_tokens) for r in results)
    print(f"served {len(results)} requests, {total} tokens in {dt:.2f}s")
    print(f"engine stats: {eng.stats()}")
    for r in results[:3]:
        print(f"  req {r.id}: {r.out_tokens[:10]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
