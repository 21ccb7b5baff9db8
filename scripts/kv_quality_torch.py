"""INT8-KV decode-path quality on the PyTorch/CUDA port (counterpart of
scripts/kv_quality.py): teacher-forced decode scoring of the perplexity
chain's held-out ids through an f32 head-major cache (the reference), a
bf16 flat one and an int8 flat one; decode ppl, dppl and argmax agreement
against f32. The functions are ggmlsharp_tpu_torch/eval/kv_quality.py.

Reads the seed-0 GGUF of scripts/ppl_chain_torch.py
(<tmp>/ppl_chain_torch_s0.gguf; KVQ_GGUF elsewhere), the corpus of PPL_SENT
sentences (3000) and KVQ_CHUNKS chunks (96); appends its table to
docs/PPL_CHAIN_TORCH.md (--doc elsewhere).

Run on the card:  python3 scripts/kv_quality_torch.py
"""
import argparse
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)


def log(m):
    print(m, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--doc", default=os.path.join(HERE, "..", "docs",
                                                  "PPL_CHAIN_TORCH.md"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from gen_corpus import make_text
    from ppl_chain_torch import card_name

    from ggmlsharp_tpu_torch import resolve_device
    from ggmlsharp_tpu_torch.eval import chain, kv_quality
    from ggmlsharp_tpu_torch.io import (GGUFReader, load_gguf_llama,
                                        tokenizer_from_gguf)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    path = os.environ.get("KVQ_GGUF", os.path.join(
        tempfile.gettempdir(), "ppl_chain_torch_s0.gguf"))
    if not os.path.exists(path):
        log(f"{path} missing: run scripts/ppl_chain_torch.py first")
        return 1
    cfg, params = load_gguf_llama(path, device=dev)
    tk = tokenizer_from_gguf(GGUFReader(path), native=True)
    n_sent = int(os.environ.get("PPL_SENT", "3000"))
    ids = np.asarray(tk.encode(make_text(n_sent, seed=chain.CORPUS_SEED)),
                     np.int32)
    X, Y = kv_quality.chunks(ids[len(ids) // 3:],
                             int(os.environ.get("KVQ_CHUNKS", "96")))
    card = card_name(dev)
    log(f"card: {card}; model {cfg.n_layer}L/{cfg.n_embd}E vocab="
        f"{cfg.n_vocab}; decode-scoring {X.shape[0]} chunks x "
        f"{X.shape[1]} tokens")
    rows = kv_quality.run(cfg, params, X, Y, log=log)
    kv_quality.append_doc(args.doc, rows, card, X.shape[0], cfg.head_dim,
                          time.time() - t0,
                          "python3 scripts/kv_quality_torch.py")
    log(f"appended the KV table to {os.path.normpath(args.doc)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
