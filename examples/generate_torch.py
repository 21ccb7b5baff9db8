"""Greedy or temperature generation with the PyTorch/CUDA port.

    python examples/generate_torch.py [--model gpt2-124m] [--format q8_0] \
        [--tokens 32] [--temperature 0.0] [--gguf path.gguf | --hf path] \
        [--prompt TEXT] [--device cuda]

--gguf loads a llama.cpp GGUF (Llama); --hf a GPT-2 safetensors file or
directory, quantized to --format on the device. With --prompt, the GGUF's
vocabulary encodes the prompt and decodes the answer (a file without one is
refused). Without --gguf / --hf, random weights show the pipeline (the
tokens mean nothing). Runs on the card unless --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt2-124m",
                    choices=("gpt2-124m", "llama-7b"))
    ap.add_argument("--format", default="q8_0")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--gguf")
    ap.add_argument("--hf")
    ap.add_argument("--prompt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ggmlsharp_tpu_torch import GType, resolve_device
    from ggmlsharp_tpu_torch.models import gpt2, llama, sampling

    dev = resolve_device(args.device)
    gt = GType[args.format.upper()]
    tokenizer = None
    if args.gguf:
        from ggmlsharp_tpu_torch.io import (GGUFReader, load_gguf_llama,
                                            tokenizer_from_gguf)

        cfg, params = load_gguf_llama(args.gguf, device=dev)
        params = llama.fuse_params(params)
        mod = llama
        reader = GGUFReader(args.gguf)
        if "tokenizer.ggml.tokens" in reader.metadata:
            tokenizer = tokenizer_from_gguf(reader)
    elif args.hf:
        from ggmlsharp_tpu_torch.io import load_hf_gpt2

        cfg, params = load_hf_gpt2(args.hf, device=dev)
        params = gpt2.quantize_params(params, gt)
        mod = gpt2
    elif args.model == "llama-7b":
        mod, cfg = llama, llama.LLAMA_7B
        params = llama.synthetic_params(cfg, gt, seed=0, device=dev)
    else:
        mod, cfg = gpt2, gpt2.GPT2_124M
        params = gpt2.quantize_params(gpt2.init_params(cfg, device=dev), gt)

    if args.prompt is not None:
        if tokenizer is None:
            raise SystemExit("--prompt needs a GGUF that carries a vocabulary")
        ids = tokenizer.encode(args.prompt)
    else:
        ids = [1, 2, 3, 4]
    prompt = torch.tensor([ids], dtype=torch.int32, device=dev)
    rng = torch.Generator(dev).manual_seed(1) if args.temperature > 0 \
        else None
    toks, _ = sampling.generate(
        mod.forward, cfg, params, prompt, mod.new_cache(cfg, 1, device=dev),
        args.tokens, temperature=args.temperature, top_k=40, rng=rng)
    out = toks[0].tolist()
    print("generated token ids:", out)
    if tokenizer is not None:
        print("text:", tokenizer.decode(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
