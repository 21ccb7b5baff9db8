"""Serve a quantized model over HTTP with the PyTorch/CUDA port
(llama.cpp-server-style JSON API; counterpart of examples/http_server.py).

    python examples/http_server_torch.py [--port 8080] [--slots 4] \
        [--device cuda]

then:
    curl -s localhost:8080/v1/generate -d '{"prompt": [1,2,3],
        "max_new_tokens": 16, "temperature": 0.7, "top_p": 0.9}'
    curl -s localhost:8080/v1/stats

GPT-2 124M with random Q8_0 weights behind serving.EngineServer (--port 0
takes a free port). Runs on the card unless --device cpu.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def start(args):
    """The started EngineServer (stop it with .stop())."""
    import torch

    from ggmlsharp_tpu_torch import GType, resolve_device
    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.serving import Engine, EngineServer

    dev = resolve_device(args.device)
    cfg = gpt2.GPT2_124M
    params = gpt2.init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev, dtype=torch.bfloat16)
    params = gpt2.quantize_params(params, GType.Q8_0)
    eng = Engine(gpt2.forward, cfg, params, batch_slots=args.slots,
                 cache_dtype=torch.bfloat16, device=dev)
    return EngineServer(eng, port=args.port).start()


def main(argv=None):
    args = parse(argv)
    srv = start(args)
    print(f"serving on http://127.0.0.1:{srv.port} "
          f"(slots={args.slots}); ctrl-c to stop", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
