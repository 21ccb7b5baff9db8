#!/usr/bin/env python3
"""H100 probe of the port's two cooperative Q8_0 kernels (mlp_fused_q8,
gpt2_layer): build each with one of its tunables changed (the -D macros its
source declares), check it against the plain version, and time it as
chip_smoke.py does (CUDA-graph replay, a different weight copy a launch so
L2 is cold).

Run from the repository root on a machine with the card:
    python3 scripts/probe_q8_kernels.py
Prints one JSON line a variant: {"kernel", "variant", "config", "ms", "err"}.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MLP_VARIANTS = {
    "baseline": (),
    "blocks_sm_1": ("MLP_MAX_BLOCKS_SM=1",),
    "rw_4": ("MLP_RW=4",),
    # phase 2 as phase 1 does it: a warp an item, no split of K
    "phase2_warp_items": ("MLP_PHASE2_KSPLIT=0",),
    "no_work": ("MLP_NO_WORK=1",),  # the launch and the barrier alone
}
LAYER_VARIANTS = {
    "baseline": (),
    "blocks_sm_1": ("LAYER_MAX_BLOCKS_SM=1",),
    "blocks_sm_4": ("LAYER_MAX_BLOCKS_SM=4",),
    "no_prefetch": ("LAYER_L2_PREFETCH=0",),
    "rw_4": ("LAYER_RW=4",),
    "chunks_4": ("LAYER_CHUNKS=4",),
    # cproj as the other products: a warp a row, no split of K
    "cproj_warp_rows": ("LAYER_CPROJ_KSPLIT=0",),
    # no product at all: barriers, layer norms, attention, merge
    "no_matvec": ("LAYER_NO_MATVEC=1",),
}


def main():
    import torch

    import chip_smoke as cs
    from ggmlsharp_tpu_torch.kernels import set_defines
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import _layer_ref, gpt2_layer_step
    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_ref, mlp_fused_q8

    if not torch.cuda.is_available():
        print("probe_q8_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    for tag, cfg in cs.gpt2_configs():
        E = cfg.n_embd
        copies = max(2, -(-4 * cs.L2_BYTES // (8 * E * E * 34 // 32)))
        ws = cs.mlp_inputs(E, gen, dev, copies)
        x = torch.randn((16, E), generator=gen, device=dev)
        want = _ff_ref(*ws[0], x, quantize_acts=False)
        for variant, defines in MLP_VARIANTS.items():
            set_defines("mlp_fused_q8", defines)
            err = float((mlp_fused_q8(x, *ws[0]) - want).abs().max())
            ms = cs.time_ms(lambda i: mlp_fused_q8(x, *ws[i % copies]), 64)
            cs.emit({"kernel": "mlp_fused_q8", "variant": variant,
                     "config": tag, "ms": ms, "err": err})
        del ws
        copies = max(2, -(-4 * cs.L2_BYTES // (12 * E * E * 34 // 32)))
        blocks = cs.gpt2_blocks(cfg, copies, 2)
        kc = torch.randn((256, E), generator=gen, device=dev).bfloat16()
        xv = torch.randn((1, E), generator=gen, device=dev)
        np_t = torch.tensor([32], dtype=torch.int32, device=dev)
        args = (xv, kc, kc, np_t, cfg.n_head, cfg.ln_eps)
        want = _layer_ref(blocks[0], *args)[0]
        for variant, defines in LAYER_VARIANTS.items():
            set_defines("gpt2_layer", defines)
            err = float((gpt2_layer_step(blocks[0], *args)[0] - want)
                        .abs().max())
            ms = cs.time_ms(lambda i: gpt2_layer_step(blocks[i % copies],
                                                      *args), 2 * copies)
            cs.emit({"kernel": "gpt2_layer", "variant": variant,
                     "config": tag, "ms": ms, "err": err})
        del blocks
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
