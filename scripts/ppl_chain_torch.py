"""The perplexity chain on the PyTorch/CUDA port (counterpart of
scripts/ppl_chain.py): train -> GGUF -> reload -> re-tokenize -> HELD-OUT
perplexity, with seed spread, at fp32 and in Q8_0, Q4_0, Q4_K and Q6_K
(Q4_0 and Q4_K also with GGML_TPU_QUANT_ACTS=0). The functions are
ggmlsharp_tpu_torch/eval/chain.py; this is the command line.

Knobs (environment, the JAX script's names and defaults): PPL_STEPS (300
full-batch Adam iterations), PPL_SENT (3000 corpus sentences), PPL_SEEDS
("0,1,2"), PPL_VOCAB (512), PPL_SIZE ("small": 4L/192E/6 heads/512F;
"tiny": 2L/128E). Each seed's model is written to
<tmp>/ppl_chain_torch_s<seed>.gguf (scripts/kv_quality_torch.py reads seed
0's). Writes docs/PPL_CHAIN_TORCH.md (--doc elsewhere), with the card's name
and power limit.

Run on the card:  python3 scripts/ppl_chain_torch.py
On the CPU, small: PPL_SENT=200 PPL_STEPS=3 PPL_SEEDS=0 PPL_SIZE=tiny \\
    python3 scripts/ppl_chain_torch.py --device cpu --doc /tmp/chain.md
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)


def log(m):
    print(m, flush=True)


def card_name(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if dev.type != "cuda":
        return "CPU (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def gguf_path(seed: int) -> str:
    return os.path.join(tempfile.gettempdir(), f"ppl_chain_torch_s{seed}.gguf")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--doc", default=os.path.join(HERE, "..", "docs",
                                                  "PPL_CHAIN_TORCH.md"))
    args = ap.parse_args(argv)

    import torch
    from gen_corpus import make_text

    from ggmlsharp_tpu_torch import resolve_device
    from ggmlsharp_tpu_torch.eval import chain

    dev = resolve_device(args.device)
    # f32 training and scoring in full f32 (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    steps = int(os.environ.get("PPL_STEPS", "300"))
    n_sent = int(os.environ.get("PPL_SENT", "3000"))
    seeds = [int(s) for s in os.environ.get("PPL_SEEDS", "0,1,2").split(",")]
    vocab_size = int(os.environ.get("PPL_VOCAB", "512"))
    size = os.environ.get("PPL_SIZE", "small")
    card = card_name(dev)
    log(f"card: {card}")

    text = make_text(n_sent, seed=chain.CORPUS_SEED)
    tk, ids = chain.tokenize(text, vocab_size)
    toks, half = chain.split(ids)
    log(f"vocab={len(tk.tokens)} corpus={len(ids)} tokens ({len(text)} "
        f"chars); train={half} heldout={len(ids) - half}")
    cfg = chain.model_config(len(tk.tokens), size)
    runs = []
    for seed in seeds:
        runs.append(chain.run_seed(
            seed, cfg, toks, steps, tk, text, ids, gguf_path(seed), dev,
            log=lambda m, s=seed: log(f"[seed {s}] {m}")))
    wall = time.time() - t0
    chain.write_doc(args.doc, runs, n_sent, size, steps, len(tk.tokens),
                    card, wall, "python3 scripts/ppl_chain_torch.py")
    log(f"wrote {os.path.normpath(args.doc)} at t={wall:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
