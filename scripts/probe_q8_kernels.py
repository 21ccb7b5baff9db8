#!/usr/bin/env python3
"""H100 probe of the port's cooperative kernels: the two Q8_0 ones
(mlp_fused_q8, gpt2_layer) and the two Q4_0 ones (mlp_fused_silu_q4,
llama_layer). Build each with one of its tunables changed (the -D macros its
source declares: kernels.set_defines refuses any other), check it against
the plain version, and time it as chip_smoke.py does (CUDA-graph replay, a
different weight copy a launch so L2 is cold).

The two fused MLPs run at one activation row (MLP_ROWS): their -D tunables
shape the b = 1 instance only, and two rows or more take the multi-row
instance on the tensor cores (dq_mma.cuh), which none of them changes.

Run from the repository root on a machine with the card:
    python3 scripts/probe_q8_kernels.py          # both families
    python3 scripts/probe_q8_kernels.py q4       # or q8: one family
    python3 scripts/probe_q8_kernels.py trace    # kernel 11's phase times
    python3 scripts/probe_q8_kernels.py q4 ROOT  # the package under ROOT
With ROOT (another checkout, e.g. a parent commit's) the kernels of that
package run, and a variant whose macros its source does not declare is
reported as skipped. Prints one JSON line a variant: {"kernel", "variant",
"config", "ms", "err"};
trace one a width: each phase boundary of kernel 11 (its LAYER_TRACE build)
in us after the first CTA's entry, min / median / max over the CTAs.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MLP_ROWS = 1  # the fused MLPs' activation rows: their b = 1 instance
MLP_VARIANTS = {
    "baseline": (),  # rows a consumer unit: the plan's (1 or 2 a piece)
    "rw_1": ("MLP_RW=1",),
    "rw_2": ("MLP_RW=2",),
    "rw_4": ("MLP_RW=4",),
    "w2_at_entry": ("MLP_W2_LATE=0",),  # W2's copies issued with W1's
    # no weight copied, no product: the launch, x and the exchange of h
    "no_work": ("MLP_NO_WORK=1",),
}
LAYER_VARIANTS = {
    "baseline": (),
    "chunks_4": ("LAYER_CHUNKS=4",),
    # no weight streamed, no product: norms, barriers, attention, merge
    "no_matvec": ("LAYER_NO_MATVEC=1",),
}
SILU_VARIANTS = {
    "baseline": (),
    "warps_16": ("MLP_WARPS=16",),
    "warps_12": ("MLP_WARPS=12",),
    "rw_2": ("MLP_RW=2",),  # two (gate, up) pairs a phase-1 group
    "rw2_1": ("MLP_RW2=1",),  # one w_down row a phase-2 group
    # no weight loaded, no product: the launch, the copies and the hand-off
    "no_work": ("MLP_NO_WORK=1",),
}
LLAMA_VARIANTS = {
    "baseline": (),
    "chunks_4": ("LAYER_CHUNKS=4",),
    # no weight streamed, no product: barriers, norms, rope, attention, merge
    "no_matvec": ("LAYER_NO_MATVEC=1",),
}
# the phase boundaries csrc/gpt2_layer.cu's LAYER_TRACE build stamps, in
# its STAMP order, then the qkv piece's wait and its products' end (warp 0)
TRACE_PHASES = ("entry", "ln1", "qkv_prod", "qkv_put", "attn", "att_in",
                "proj_prod", "x2_put", "x2_in", "ln2", "fc_prod", "h_put",
                "h_in", "cproj_prod", "y_put", "end", "qkv_wait", "qkv_done")
# kernel name -> its variant table
TABLES = {"mlp_fused_q8": MLP_VARIANTS, "gpt2_layer": LAYER_VARIANTS,
          "mlp_fused_silu_q4": SILU_VARIANTS, "llama_layer": LLAMA_VARIANTS}


def declared(kernel, defines) -> bool:
    """Whether the kernel's source declares every macro of ``defines`` (a
    checkout of another commit may declare other tunables)."""
    from ggmlsharp_tpu_torch.kernels import _build

    names = _build.declared_macros(kernel)
    return all(d.split("=", 1)[0] in names for d in defines)


def prebuild(tables):
    """Build every declared variant of ``tables`` ({kernel: variant table})
    at once, one nvcc process a library, before any of them is timed."""
    from ggmlsharp_tpu_torch import kernels

    kernels.build([], variants=[(k, d) for k, table in tables.items()
                                for d in table.values() if declared(k, d)])


def probe_q4(cs, dev, gen):
    """The Q4_0 kernels at Llama-7B's widths: the fused MLP at 1 row (its
    -D tunables shape the b = 1 instance only; more rows take the multi-row
    instance on the tensor cores, dq_mma.cuh), the whole-block kernel at T
    256 / npast 32 and T 2048 / npast 2047."""
    import torch

    from ggmlsharp_tpu_torch.kernels import set_defines
    from ggmlsharp_tpu_torch.kernels.llama_layer import (_layer_ref,
                                                         llama_layer_step,
                                                         rope_vectors)
    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_silu_ref, mlp_fused_silu_q4
    from ggmlsharp_tpu_torch.models import llama

    prebuild({"mlp_fused_silu_q4": SILU_VARIANTS,
              "llama_layer": LLAMA_VARIANTS})
    cfg = llama.LLAMA_7B
    E, F = cfg.n_embd, cfg.n_ff
    copies = 3  # a pair is 76 MB, a block 114 MB: each exceeds L2 alone
    ws = [(llama.random_q4_0(2 * F, E, gen, dev),
           llama.random_q4_0(E, F, gen, dev)) for _ in range(copies)]
    for n_rows in (MLP_ROWS,):
        x = torch.randn((n_rows, E), generator=gen, device=dev)
        want = _ff_silu_ref(*ws[0], x, quantize_acts=False)
        for variant, defines in SILU_VARIANTS.items():
            if not declared("mlp_fused_silu_q4", defines):
                cs.emit({"kernel": "mlp_fused_silu_q4", "variant": variant,
                         "skipped": "undeclared"})
                continue
            set_defines("mlp_fused_silu_q4", defines)
            err = float((mlp_fused_silu_q4(x, *ws[0]) - want).abs().max())
            ms = cs.time_ms(lambda i: mlp_fused_silu_q4(x, *ws[i % copies]),
                            24)
            cs.emit({"kernel": "mlp_fused_silu_q4", "variant": variant,
                     "config": f"7B rows {n_rows}", "ms": ms, "err": err})
    set_defines("mlp_fused_silu_q4", ())
    del ws
    torch.cuda.empty_cache()
    cfg, blocks = cs.llama_blocks(cfg, copies, 2, gen, dev)
    kc = torch.randn((2048, E), generator=gen, device=dev).bfloat16()
    xv = torch.randn((1, E), generator=gen, device=dev)
    for T, npast in ((256, 32), (2048, 2047)):
        np_t = torch.tensor([npast], dtype=torch.int32, device=dev)
        rope = rope_vectors(np_t, cfg)
        args = (xv, kc[:T], kc[:T], np_t, cfg, rope)
        want = _layer_ref(blocks[0], *args)[0]
        for variant, defines in LLAMA_VARIANTS.items():
            set_defines("llama_layer", defines)
            err = float((llama_layer_step(blocks[0], *args)[0] - want)
                        .abs().max())
            ms = cs.time_ms(lambda i: llama_layer_step(blocks[i % copies],
                                                       *args), 24)
            cs.emit({"kernel": "llama_layer", "variant": variant,
                     "config": f"7B T {T} npast {npast}", "ms": ms,
                     "err": err})
    set_defines("llama_layer", ())


def main():
    import torch

    import chip_smoke as cs

    family = sys.argv[1] if len(sys.argv) > 1 else "all"
    if family not in ("all", "q4", "q8", "trace") or len(sys.argv) > 3:
        print("usage: probe_q8_kernels.py [q4|q8|trace] [ROOT]",
              file=sys.stderr)
        return 2
    if len(sys.argv) > 2:  # the package of another checkout
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
    if not torch.cuda.is_available():
        print("probe_q8_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    if family in ("all", "q4"):
        probe_q4(cs, dev, gen)
    if family in ("all", "q8"):
        probe_q8(cs, dev, gen)
    if family == "trace":
        trace_gpt2_layer(cs, dev, gen)
    return 0


def probe_q8(cs, dev, gen):
    """The Q8_0 kernels at GPT-2 124M's and 774M's widths."""
    prebuild({"mlp_fused_q8": MLP_VARIANTS, "gpt2_layer": LAYER_VARIANTS})
    probe_mlp_q8(cs, dev, gen)
    probe_layer_q8(cs, dev, gen)


def probe_mlp_q8(cs, dev, gen):
    """Kernel 8 at MLP_ROWS activation rows, each variant of its b = 1
    instance."""
    import torch

    from ggmlsharp_tpu_torch.kernels import mlp_fused, set_defines

    for tag, cfg in cs.gpt2_configs():
        E = cfg.n_embd
        copies = max(2, -(-4 * cs.L2_BYTES // (8 * E * E * 34 // 32)))
        ws = cs.mlp_inputs(E, gen, dev, copies)
        x = torch.randn((MLP_ROWS, E), generator=gen, device=dev)
        want = mlp_fused._ff_ref(*ws[0], x, quantize_acts=False)
        for variant, defines in MLP_VARIANTS.items():
            if not declared("mlp_fused_q8", defines):
                cs.emit({"kernel": "mlp_fused_q8", "variant": variant,
                         "skipped": "undeclared"})
                continue
            set_defines("mlp_fused_q8", defines)
            err = float((mlp_fused.mlp_fused_q8(x, *ws[0]) - want)
                        .abs().max())
            ms = cs.time_ms(lambda i: mlp_fused.mlp_fused_q8(
                x, *ws[i % copies]), 64)
            cs.emit({"kernel": "mlp_fused_q8", "variant": variant,
                     "config": f"{tag} rows {MLP_ROWS}", "ms": ms,
                     "err": err})
        set_defines("mlp_fused_q8", ())
        del ws


def probe_layer_q8(cs, dev, gen):
    """Kernel 11 at T 256, npast 32, bf16 cache."""
    import torch

    from ggmlsharp_tpu_torch.kernels import set_defines
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import _layer_ref, gpt2_layer_step

    for tag, cfg in cs.gpt2_configs():
        E = cfg.n_embd
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
        set_defines("gpt2_layer", ())
        del blocks
        torch.cuda.empty_cache()


def trace_gpt2_layer(cs, dev, gen, calls=4):
    """Kernel 11 built with LAYER_TRACE=1 at both GPT-2 widths, T 256, npast
    32, bf16 cache, ``calls`` calls over as many blocks' weights; the last
    call's stamps (each CTA's clock at TRACE_PHASES, scaled to ns by the
    global timer over its run and offset by its entry's global time), read
    back from the partials' scratch that the trace build writes over."""
    import numpy as np
    import torch

    from ggmlsharp_tpu_torch.kernels import set_defines
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import gpt2_layer_step

    G = torch.cuda.get_device_properties(dev).multi_processor_count
    set_defines("gpt2_layer", ("LAYER_TRACE=1",))
    try:
        for tag, cfg in cs.gpt2_configs():
            E = cfg.n_embd
            blocks = cs.gpt2_blocks(cfg, calls, 2)
            kc = torch.randn((256, E), generator=gen, device=dev).bfloat16()
            x = torch.randn((1, E), generator=gen, device=dev)
            np_t = torch.tensor(32, dtype=torch.int32, device=dev)
            for blk in blocks:
                y = gpt2_layer_step(blk, x, kc, kc, np_t, cfg.n_head,
                                    cfg.ln_eps)[0]
            torch.cuda.synchronize()
            # y [E], qkv [3E], then the partials' scratch: 20 words a CTA
            w = y._base[4 * E:4 * E + 20 * G].view(torch.int32).view(G, 20)
            w = w.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
            ns_clk = w[:, 19] / np.maximum(w[:, 15], 1)
            at = (w[:, 18] - w[:, 18].min())[:, None] + w[:, :18] * ns_clk[:, None]
            phases = {}
            for i, name in enumerate(TRACE_PHASES):
                v = at[:, i] if i < 16 else at[w[:, i] > 0, i]
                if len(v):
                    phases[name] = [round(float(f(v)) / 1e3, 3)
                                    for f in (np.min, np.median, np.max)]
            cs.emit({"kernel": "gpt2_layer", "trace": tag,
                     "ns_per_clock": float(np.median(ns_clk)),
                     "phases_us": phases})
            del blocks
            torch.cuda.empty_cache()
    finally:
        set_defines("gpt2_layer", ())


if __name__ == "__main__":
    sys.exit(main())
