"""Speculative decoding with the PyTorch/CUDA port: a draft model proposes
k tokens a round and the target verifies them in one forward
(models/speculative.py), with the target's own greedy tokens.

    python examples/speculative_torch.py [--tokens 48] [--k 4] \
        [--target-gguf big.gguf] [--draft-gguf small.gguf] [--device cuda]

Without GGUFs this runs two random tiny Llamas (same vocabulary): the
machinery (the draft chain, one-forward verification, per-slot accept
counts, O(1) cache rollback) runs, but a random draft rarely agrees with a
random target, so the tokens a round stay near 1. With a real draft /
target pair each weight read of the target serves 2-4 tokens. Runs on the
card unless --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--k", type=int, default=4, help="draft tokens a round")
    ap.add_argument("--target-gguf")
    ap.add_argument("--draft-gguf")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ggmlsharp_tpu_torch import resolve_device
    from ggmlsharp_tpu_torch.models import llama, sampling
    from ggmlsharp_tpu_torch.models.speculative import speculative_generate

    dev = resolve_device(args.device)
    if args.target_gguf:
        from ggmlsharp_tpu_torch.io import load_gguf_llama

        tcfg, tp = load_gguf_llama(args.target_gguf, device=dev)
        dcfg, dp = load_gguf_llama(args.draft_gguf or args.target_gguf,
                                   device=dev)
    else:
        tcfg = dcfg = llama.TINY_LLAMA
        tp = llama.init_params(tcfg, torch.Generator(dev).manual_seed(0),
                               device=dev, dtype=torch.float32)
        dp = llama.init_params(dcfg, torch.Generator(dev).manual_seed(1),
                               device=dev, dtype=torch.float32)

    prompt = torch.tensor([[1, 12, 7, 99, 4, 25]], dtype=torch.int32,
                          device=dev)
    n = args.tokens
    need = prompt.shape[1] + n + args.k + 2  # the rounds' headroom
    ref, _ = sampling.generate(
        llama.forward, tcfg, tp, prompt,
        llama.new_cache(tcfg, 1, dtype=torch.float32, device=dev), n)
    toks, rate = speculative_generate(
        llama.forward, tcfg, tp, llama.forward, dcfg, dp, prompt,
        llama.new_cache(tcfg, 1, dtype=torch.float32, max_len=need,
                        device=dev),
        llama.new_cache(dcfg, 1, dtype=torch.float32, max_len=need,
                        device=dev), n, k=args.k)

    exact = torch.equal(toks, ref)
    print(f"tokens: {toks[0].tolist()}")
    print(f"greedy-exact vs target-only decode: {exact}")
    print(f"amortisation: {rate:.2f} tokens emitted a target forward "
          f"(max {args.k + 1})")
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
