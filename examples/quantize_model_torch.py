"""Quantize a model with the PyTorch/CUDA port and export it as a
llama.cpp-compatible GGUF (counterpart of examples/quantize_model.py).

    python examples/quantize_model_torch.py --out /tmp/model-q4_0.gguf \
        [--format q4_0] [--hf path.safetensors|dir] [--device cuda]

Without --hf, a tiny random Llama (2 layers, 256 wide) is quantized. The
weights whose rows are whole 256-element groups take --format; the rest
stay as they are (llama.quantize_params' policy, the JAX package's). Runs
on the card unless --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

TINY = dict(n_vocab=512, n_ctx=128, n_embd=256, n_head=8, n_head_kv=4,
            n_layer=2, n_ff=512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--format", default="q4_0")
    ap.add_argument("--hf", help="HF llama safetensors path (else tiny random)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ggmlsharp_tpu_torch import GType, resolve_device
    from ggmlsharp_tpu_torch.io import save_gguf_llama
    from ggmlsharp_tpu_torch.models import llama

    dev = resolve_device(args.device)
    gt = GType[args.format.upper()]
    if args.hf:
        from ggmlsharp_tpu_torch.io import load_hf_llama

        cfg, params = load_hf_llama(args.hf, device=dev)
    else:
        cfg = llama.LlamaConfig(**TINY)
        params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                   device=dev, dtype=torch.float32)
    # fused and padded for the card; save_gguf_llama writes llama.cpp's
    # unfused, unpadded tensors
    qparams = llama.quantize_params(params, gt)
    save_gguf_llama(args.out, cfg, qparams)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"{gt.name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
