#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ggmlsharp_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each failing loudly (nothing falls back to the CPU or to a plain
version):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ with nvcc, one process a source;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it, and every launch geometry of the three
     dequant-matmul sources against the default bit for bit;
  4. the paths, each with the launch counters reset just before and
     read just after, and each held against its plain path:
     a. b = 1 decode: Llama-7B (full width and depth, random Q4_0 weights
        from a seed), a 16-token prompt and 32 greedy tokens through
        sampling.generate;
     b. serving: serving.Engine over the same model with an INT8 flat KV
        cache, 8 slots, 24 requests of 16 prompt tokens and 24 new tokens
        each; then a replay of its admission prefill and decode steps
        through the kernels and the plain path, and three concurrent HTTP
        requests through serving.EngineServer;
     c. GPT-2 Q8_0 greedy decode at b = 1, at the full width and depth of
        GPT-2 124M and of GPT-2 774M (random Q8_0 weights from a seed, flat
        bf16 cache): a 16-token prompt (per-matmul Q8_0 kernel, flash, the
        fused MLP kernel) and 32 greedy tokens (one whole-block kernel call
        a layer) through sampling.generate;
     d. Llama-7B Q4_0 through its two fused routes, the weights of path a
        plus the whole-block route's own wo copies: with both switches on
        and a flat bf16 cache, the 16-token prompt (Q4_0 matmul, flash, the
        fused SwiGLU MLP at 16 rows) and 32 greedy tokens (one whole-block
        kernel call a layer, the LM head); then with the fused MLP alone
        over the head-major cache, the prompt and 8 greedy tokens (the fused
        MLP at b = 1, once a layer a token);
     e. BASELINE config 3: Llama-7B (full width and depth) with every matmul
        weight and both tables in Q4_K, then in Q6_K (random from the seed,
        quantized on the card), an INT8 flat cache of 2048 rows: the 16-token
        prompt and 32 greedy tokens (matmul_q.cu in every matmul, flash for
        the prompt, attn_decode in every decode step);
     f. at full width and 8 layers, a 16-token prompt and 8 greedy tokens
        each: Q4_1, Q4_2, Q4_3, Q5_0, Q5_1 over the bf16 head-major cache
        (matmul_q.cu), then GGML_TPU_INT_DOT=1 with Q8_0, Q4_0, Q4_1, Q5_0,
        Q5_1 (matmul_int_dot.cu in every decode matmul but the LM head's);
     g. training: GPT-2 124M (full width and depth, bf16 parameters from a
        seed), one batch of 8 x 129 tokens, the JAX bench's loss; the loss
        and every gradient against the plain route, then 4 Adam steps
        through optim.opt_fn (the cached flash entry's Function in every
        layer, its backward a dense recompute);
     h. the graph layer: the reference's Test3 (4096 x 256 L-BFGS fit) by
        ggml_opt on the card, then a graph-API decoder (E 768, 12 heads, S
        128, 2 layers) with flash_attn: forward, backward graph against the
        plain route, and 4 Adam steps of opt() (the uncached flash entry);
     and GPT-2 124M behind serving.Engine with an INT8 (head-major) cache,
     against the same engine's plain run; then the tuning path:
     the TPU probes' counterparts (probes/: the three Q4_UNPACK builds of
     matmul_q4_0.cu, i2f bit-equal to prmt and half2 within its bar; the
     copy ceiling at 8 MB and 1 GiB; the byte map; the K-major matvec; the
     f16 decode, block maps and bad-entry map), the tune table's entries
     timed against the default geometry at b = 1, where dispatch reads
     them, and at b = 8, where it does not (its card checked against this
     one), and the host cost of the table's lookup, and
     i. LLAMA_13B Q4_0 (full width and depth, random weights quantized on
        the card) at b = 1: a 16-token prompt and 8 greedy tokens, every
        b = 1 matmul through matmul_q4_0 at the tune table's geometry for
        its shape (the prompt's at the default); held against the plain
        route; tok/s and roofline share;
  5. each kernel's time at the paths' shapes (CUDA events), beside its
     plain version, one PyTorch library call and its bound; kernel 2 also
     at path g's shape, both entries, softcap, and its backward against
     SDPA's;
  6. decode tokens/s at batch 1, its share of the HBM roofline, prefill
     time, peak device memory, and a torch.profiler window of decode steps
     (device time, launches and host operator calls a step, idle share);
     serving tokens/s, time to first token, latency, ticks, peak memory
     and the share of the batched roofline; the same decode measurements
     for GPT-2 124M and 774M, for Llama-7B on its whole-block route and
     for path e in Q4_K and Q6_K; path g's step time, tokens/s, share of
     the bf16 dense peak and peak memory.

Exits non-zero without a card or outside a checkout of the repository.
Prints JSON lines; the one before the card line lists the kernels; the last
is {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_S = 67e12     # H100 SXM f32 outside the tensor cores
INT8_OP_S = 1979e12    # H100 SXM int8 tensor cores, dense
BF16_FLOP_S = 989e12   # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50 * 2**20
SEED = 0
PROMPT_LEN, N_NEW, N_CMP = 16, 32, 8
MLP_STEPS = 8  # decode steps of path d's fused-MLP-alone run
# the serving path: bench.py's serve defaults at 8 slots, INT8 KV cache
SLOTS, SERVE_MAX_LEN, SERVE_REQS, SERVE_PLEN, SERVE_NEW = 8, 256, 24, 16, 24
REPLAY_STEPS = 8  # decode steps of the serving replay
ATTN_TIMING_T = (64, 256, 2048)  # attn_decode timing: cache rows a slot
# Llama-7B matmuls a decode token runs: (name, N, K, launches a token)
Q4_SHAPES = [("wqkv", 12288, 4096, 32), ("wo", 4096, 4096, 32),
             ("w_gate_up", 22016, 4096, 32), ("w_down", 4096, 11008, 32),
             ("output", 32000, 4096, 1)]


GPT2_V = 50257


def gpt2_shapes(E):
    """The Q8_0 matmuls of a GPT-2 of width E: (name, N, K)."""
    return [("c_attn", 3 * E, E), ("c_proj", E, E), ("c_fc", 4 * E, E),
            ("mlp_c_proj", E, 4 * E), ("wte", GPT2_V, E)]


def gpt2_configs():
    from ggmlsharp_tpu_torch.models import gpt2

    return [("124M", gpt2.GPT2_124M), ("774M", gpt2.GPT2_774M)]


def log(msg):
    print(msg, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps, warmup=3):
    """Mean device ms a call of fn(i), i = 0..reps-1 (i picks the caller's
    input copy): the reps calls captured into one CUDA graph, its replay
    timed with CUDA events (the package's probes.common.time_ms)."""
    from ggmlsharp_tpu_torch.probes.common import time_ms as graph_time_ms

    return graph_time_ms(fn, reps, warmup)


def q4_bound_ms(b, n, k, q8_acts):
    """Bytes: packed weight, x and y once each. Operations: 2*b*n*k; after
    the Q8_0 round trip the operands are int8 x int4 values, which the
    int8 tensor cores multiply exactly; the LM head's x stays f32."""
    bytes_ = n * k * 18 // 32 + b * k * 4 + b * n * 4
    flops = 2 * b * n * k
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = flops / (INT8_OP_S if q8_acts else F32_FLOP_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_bound_ms(B, Hq, Hkv, S, D, npast, kv_itemsize):
    """Bytes of q, out and the K/V rows causality keeps; f32 FMAs of the
    kept scores. npast: list of ints, one a batch entry."""
    kv_rows = sum(n + S for n in npast)
    bytes_ = 2 * B * Hq * S * D * 4 + 2 * Hkv * kv_rows * D * kv_itemsize
    pairs = sum(S * n + S * (S + 1) // 2 for n in npast)  # (query, key) kept
    flops = 4 * Hq * pairs * D
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_q4_0(dev, gen):
    """Kernel (through its wrapper) vs plain at every 7B shape, b in {1, 16}.
    Tolerance: the two sum K f32 products in different orders; allow 1e-5
    of sum_k |x_k w_nk| (2^-24 is 6e-8 a rounding)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused
    from ggmlsharp_tpu_torch.models.llama import random_q4_0
    from ggmlsharp_tpu_torch.ops import mul_mat_q
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    worst, rows = 0.0, []
    for name, n, k, _ in Q4_SHAPES:
        w = random_q4_0(n, k, gen, dev)
        wabs = dequantize(w).abs()
        # b = 1 and 8 slots decode; 16 and 8 x 16 rows prefill
        for b in (1, SLOTS, 16, SLOTS * 16):
            x = torch.randn((b, k), generator=gen, device=dev)
            qa = name != "output"  # the LM head skips the Q8 round trip
            got = mul_mat_q_fused(w, x, quantize_acts=qa)
            want = mul_mat_q(w, x, quantize_acts=qa)
            scale = x.abs() @ wabs.T
            err = (got - want).abs()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= 1e-5 * scale).all())
            e = float(err.max())
            worst = max(worst, e)
            rows.append({"shape": name, "b": b, "n": n, "k": k,
                         "max_abs_err": e,
                         "max_err_over_sum_abs": float((err / scale).max()),
                         "ok": ok})
            if not ok:
                emit({"q4_0_check": rows})
                raise SystemExit(f"Q4_0 kernel disagrees at {name} b={b}")
        del w, wabs
    emit({"q4_0_check": rows})
    return worst


def q4_rows_independent_of_b(dev, gen):
    """Whether a row's Q4_0 result is bit for bit the same at b = 1, 8 and
    128 (the kernel has one instantiation for b = 1, another for b > 1)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import q4_0_matmul
    from ggmlsharp_tpu_torch.models.llama import random_q4_0

    w = random_q4_0(4096, 4096, gen, dev)
    x = torch.randn((SLOTS * 16, 4096), generator=gen, device=dev)
    y = q4_0_matmul(x, w["qs"], w["d"])
    return all(torch.equal(y[:b], q4_0_matmul(x[:b].contiguous(), w["qs"],
                                              w["d"])) for b in (1, SLOTS))


def rms_rows_independent_of_b(dev, gen, trials=64):
    """How often a row of the port's rms norm (llama._rms, and the
    torch.mean inside it) differs bit for bit between a batch of SLOTS rows
    of [SLOTS, 1, E] and the row alone, as a slot's decode step gives it in
    an 8-slot engine and in a one-slot one; f32 rows (the residual stream
    after the first block) and bf16 rows (the embedding, first block)."""
    import torch

    from ggmlsharp_tpu_torch.models.llama import _rms

    E = 4096
    g = torch.ones(E, dtype=torch.bfloat16, device=dev)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        n_rms = n_mean = 0
        worst = 0.0
        for _ in range(trials):
            x = torch.randn((SLOTS, 1, E), generator=gen, device=dev).to(dt)
            xf = x.float()
            batch, ms = _rms(x, g, 1e-6), torch.mean(xf * xf, -1)
            for b in range(SLOTS):
                alone = _rms(x[b:b + 1].contiguous(), g, 1e-6)
                n_rms += not torch.equal(alone[0], batch[b])
                n_mean += not torch.equal(
                    torch.mean(xf[b:b + 1] * xf[b:b + 1], -1)[0], ms[b])
                worst = max(worst, float((alone[0] - batch[b]).abs().max()))
        res[str(dt).split(".")[1]] = {
            "rows": trials * SLOTS, "rms_rows_differ": n_rms,
            "mean_rows_differ": n_mean, "max_abs_diff": worst}
    emit({"rms_rows_vs_b": res})
    return res


FLASH_CASES = [  # (label, B, Hq, Hkv, S, T used, T allocated, D, npast, kv dtype)
    ("7b_prefill", 1, 32, 32, 16, 256, 2048, 128, [0], "bf16"),
    ("gqa_npast", 2, 32, 8, 40, 512, 1024, 128, [100, 7], "bf16"),
    ("d64_f32", 1, 8, 4, 20, 64, 64, 64, [10], "f32"),
    # the serving path's admission prefill: 8 fresh prompts, f32 K/V
    ("serve_prefill", SLOTS, 32, 32, 16, 16, 16, 128, [0] * SLOTS, "f32"),
    # the GPT-2 paths' prefill: the call's own fresh f32 K/V, D 64
    ("gpt2_124m_prefill", 1, 12, 12, 16, 16, 16, 64, [0], "f32"),
    ("gpt2_774m_prefill", 1, 20, 20, 16, 16, 16, 64, [0], "f32"),
]


def check_flash(dev, gen):
    """Kernel vs plain _cached_ref: rtol 2e-4 / atol 2e-5 (online vs dense
    softmax, f32 summation order; the JAX package's kernel test bar)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.flash import _cached_ref, flash_attention_cached

    worst, rows = 0.0, []
    for label, B, Hq, Hkv, S, T, Ta, D, npast, kvd in FLASH_CASES:
        dt = torch.bfloat16 if kvd == "bf16" else torch.float32
        q = torch.randn((B, Hq, S, D), generator=gen, device=dev)
        kc = torch.randn((B, Hkv, Ta, D), generator=gen, device=dev).to(dt)
        vc = torch.randn((B, Hkv, Ta, D), generator=gen, device=dev).to(dt)
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
        got = flash_attention_cached(q, kc[:, :, :T], vc[:, :, :T], np_t)
        want = _cached_ref(q, kc[:, :, :T], vc[:, :, :T], np_t, D ** -0.5)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= 2e-5 + 2e-4 * want.abs()).all())
        e = float(err.max())
        worst = max(worst, e)
        rows.append({"case": label, "max_abs_err": e, "ok": ok})
        if not ok:
            emit({"flash_check": rows})
            raise SystemExit(f"flash kernel disagrees in case {label}")
    emit({"flash_check": rows})
    return worst


ATTN_CASES = [  # (label, B, Hq, Hkv, T, npast a slot, cache)
    ("mha_int8_T64", SLOTS, 32, 32, 64, [0, 63, 5, 17, 40, 1, 62, 33], "int8"),
    ("mha_int8_T2048", SLOTS, 32, 32, 2048,
     [0, 2047, 100, 1000, 1500, 7, 2046, 512], "int8"),
    ("mha_bf16_T64", SLOTS, 32, 32, 64, [0, 63, 5, 17, 40, 1, 62, 33], "bf16"),
    ("mha_bf16_T2048", SLOTS, 32, 32, 2048,
     [0, 2047, 100, 1000, 1500, 7, 2046, 512], "bf16"),
    ("gqa8_int8_T2048", SLOTS, 32, 8, 2048,
     [0, 2047, 100, 1000, 1500, 7, 2046, 512], "int8"),
    # D = 64, GQA n_rep 4, npast past the prefix view for one slot
    ("gqa4_bf16_d64_T300", 4, 8, 2, 300, [0, 299, 150, 400], "bf16"),
]


def decode_inputs(dev, gen, B, Hq, Hkv, T, kind, copies=1, D=128):
    """Random decode-attention inputs: q, fresh rows, and ``copies`` caches
    (k, v, scales), each a T-row prefix view of a longer buffer. INT8 rows
    are uniform in [-127, 127] with scales in [0, 1/64), so values are of
    the order of 1, like the float rows."""
    import torch

    E, Ta = Hkv * D, T + 64
    q = torch.randn((B, Hq, D), generator=gen, device=dev)
    kn = torch.randn((B, E), generator=gen, device=dev)
    vn = torch.randn((B, E), generator=gen, device=dev)
    caches = []
    for _ in range(copies):
        if kind == "int8":
            kv = [torch.randint(-127, 128, (B, Ta, E), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2)]
            sc = [torch.rand((B, Ta, Hkv), generator=gen, device=dev) / 64
                  for _ in range(2)]
            caches.append((kv[0][:, :T], kv[1][:, :T],
                           {"k_scale": sc[0][:, :T], "v_scale": sc[1][:, :T]}))
        else:
            kv = [torch.randn((B, Ta, E), generator=gen, device=dev)
                  .to(torch.bfloat16)
                  for _ in range(2)]
            caches.append((kv[0][:, :T], kv[1][:, :T], {}))
    return q, kn, vn, caches


def check_attn_decode(dev, gen):
    """Kernel vs plain _decode_ref: rtol 2e-4 / atol 2e-5 (both f32; online
    vs dense softmax and summation order)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import _decode_ref, flash_decode_flat

    worst, rows = 0.0, []
    for label, B, Hq, Hkv, T, npast, kind in ATTN_CASES:
        D = 64 if "d64" in label else 128
        q, kn, vn, ((kc, vc, sc),) = decode_inputs(dev, gen, B, Hq, Hkv, T,
                                                   kind, D=D)
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
        got = flash_decode_flat(q, kn, vn, kc, vc, np_t, Hkv, D, **sc)
        want = _decode_ref(q, kn, vn, kc, vc, np_t, Hkv, D, **sc)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= 2e-5 + 2e-4 * want.abs()).all())
        e = float(err.max())
        worst = max(worst, e)
        rows.append({"case": label, "max_abs_err": e, "ok": ok})
        if not ok:
            emit({"attn_decode_check": rows})
            raise SystemExit(f"attn_decode kernel disagrees in case {label}")
    emit({"attn_decode_check": rows})
    return worst


def run_main_path(cfg, params, prompt):
    """sampling.generate through the kernels, counters reset just before."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import llama, sampling

    cache = llama.new_cache(cfg, 1)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks, cache = sampling.generate(llama.forward, cfg, params, prompt, cache,
                                    N_NEW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "matmul_q4_0": 129 * (1 + N_NEW),  # 4 a block x 32 + LM head
        "flash_attn": cfg.n_layer}         # one a layer, prefill only
    # attn_decode 0: a head-major cache decodes through einsum
    emit({"main_path": {"tokens": toks[0].tolist(), "seconds": seconds,
                        "launches": counts, "expected_launches": want}})
    if counts != want:
        raise SystemExit(f"launch counts {counts} != expected {want}")
    if toks.shape != (1, N_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.n_vocab:
        raise SystemExit(f"bad tokens {toks}")
    if int(cache.length[0]) != PROMPT_LEN + N_NEW:
        raise SystemExit("cache length is wrong")
    return toks, counts


def compare_plain(model, cfg, params, prompt, quant_acts, cache_dtype, tol,
                  toks=None, route=None, **cache_kw):
    """Kernel path vs plain path of ``model`` (models.llama or models.gpt2),
    step for step, under one setting.

    ``toks``: greedy tokens that sampling.generate made under this setting;
    None runs generate here. Both paths then replay generate's prefill and
    its first N_CMP - 1 steps, fed those tokens, so row i holds the logits
    that chose token i. Fails unless every row agrees within ``tol``, each
    token is the argmax of the kernel path's row, and each token is the
    plain argmax wherever the plain top-2 gap exceeds 2 * tol (logits
    within tol of each other cannot reorder such a pair). ``route`` names
    the path in the printed row; ``cache_kw`` goes to new_cache."""
    import functools

    import torch

    from ggmlsharp_tpu_torch.models import sampling

    os.environ["GGML_TPU_QUANT_ACTS"] = "1" if quant_acts else "0"
    try:
        if toks is None:
            toks, _ = sampling.generate(
                model.forward, cfg, params, prompt,
                model.new_cache(cfg, 1, dtype=cache_dtype, **cache_kw), N_CMP)
        out = {}
        with torch.inference_mode():
            for plain in (False, True):
                prefill, step = sampling.make_decode_fns(
                    functools.partial(model.forward, plain=plain), cfg)
                cache = model.new_cache(cfg, 1, dtype=cache_dtype, **cache_kw)
                cur = PROMPT_LEN
                lg, cache = prefill(params, prompt, cache,
                                    t_eff=sampling.length_bucket(cur, cfg.n_ctx))
                rows = [lg[0].float()]
                for i in range(N_CMP - 1):
                    cur += 1
                    lg, cache = step(params, toks[:, i:i + 1], cache,
                                     t_eff=sampling.length_bucket(cur, cfg.n_ctx))
                    rows.append(lg[0].float())
                out[plain] = torch.stack(rows)
    finally:
        os.environ.pop("GGML_TPU_QUANT_ACTS")
    kern, ref = out[False], out[True]
    tk = toks[0, :N_CMP].long()
    err = float((kern - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = ref.argmax(-1) == tk
    decided = gap > 2 * tol
    row = {"model": model.__name__.rsplit(".", 1)[-1], "route": route,
           "n_layer": cfg.n_layer, "quantize_acts": quant_acts,
           "cache": str(cache_dtype),
           "steps": N_CMP, "max_abs_err": err,
           "max_abs_logit": float(ref.abs().max()), "tol": tol,
           "tokens_are_kernel_argmax": bool((kern.argmax(-1) == tk).all()),
           "tokens_equal_plain_argmax": int(same.sum()),
           "tokens_decided": int(decided.sum()),
           "decided_tokens_agree": bool(same[decided].all()),
           "min_top2_gap": float(gap.min()),
           "finite": bool(torch.isfinite(kern).all())}
    emit({"plain_compare": row})
    if not (row["finite"] and err <= tol and row["tokens_are_kernel_argmax"]
            and row["decided_tokens_agree"]):
        raise SystemExit(f"kernel path disagrees with the plain path: {row}")
    return err


def serving_prompts(cfg):
    """bench.py's serve workload: SERVE_REQS prompts of SERVE_PLEN tokens."""
    import numpy as np

    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.n_vocab, size=SERVE_PLEN).tolist()
            for _ in range(SERVE_REQS)]


def new_engine(cfg, params, forward=None, slots=SLOTS):
    import torch

    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.serving import Engine

    return Engine(forward or llama.forward, cfg, params, batch_slots=slots,
                  max_len=SERVE_MAX_LEN, int8_kv=True,
                  cache_dtype=torch.bfloat16)


def run_serving(cfg, params):
    """The serving path: a warm-up engine answers one admission wave of 2
    tokens each; a fresh engine then answers the SERVE_REQS requests, with
    the launch counters reset just before its run and read just after.
    Every admission prefill here is a 16-row bucket (S > 8: flash), every
    decode forward a batched single-token step (attn_decode)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.serving import Request

    prompts = serving_prompts(cfg)
    warm = new_engine(cfg, params)
    for i in range(SLOTS):
        warm.submit(Request(id=i, prompt=prompts[i], max_new_tokens=2))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = new_engine(cfg, params)
    for i, p in enumerate(prompts):
        eng.submit(Request(id=i, prompt=p, max_new_tokens=SERVE_NEW))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    st = eng.stats()
    n_dec, n_pre = st["decode_forwards"], st["prefill_dispatches"]
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "matmul_q4_0": (4 * cfg.n_layer + 1) * (n_dec + n_pre),
        "flash_attn": cfg.n_layer * n_pre,
        "attn_decode": cfg.n_layer * n_dec}
    res = {"requests": len(results), "seconds": seconds, "stats": st,
           "launches": counts, "expected_launches": want,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_tokens": [r.out_tokens[:4] for r in results[:3]]}
    emit({"serving_path": res})
    if counts != want or n_dec == 0:
        raise SystemExit(f"serving launch counts {counts} != expected {want}")
    bad = [r.id for r in results
           if r.error is not None or len(r.out_tokens) != SERVE_NEW
           or not all(0 <= t < cfg.n_vocab for t in r.out_tokens)]
    if len(results) != SERVE_REQS or bad:
        raise SystemExit(f"serving answered {len(results)} requests, bad {bad}")
    return eng, res


def replay_serving(cfg, params, tol):
    """Kernel engine vs plain engine over the engine's own forward calls:
    one batched admission prefill of 8 prompts of uneven length (4-16
    tokens), then REPLAY_STEPS batched decode steps, both fed the kernel
    path's greedy tokens. Row j holds the logits that chose token j. Fails
    unless every row agrees within ``tol``, and each token is the plain
    argmax wherever the plain top-2 gap exceeds 2 * tol. Then slot 0's
    prompt alone through a one-slot engine shows whether a slot's logits
    depend on the other slots; and a profiled window of batched decode
    steps gives the device time a step."""
    import functools

    import numpy as np
    import torch

    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.models.sampling import length_bucket
    from ggmlsharp_tpu_torch.serving import Request

    rng = np.random.default_rng(11)
    lens = [4, 16, 7, 12, 9, 5, 14, 10]
    prompts = [rng.integers(0, cfg.n_vocab, size=n).tolist() for n in lens]
    toks = None

    def replay(forward, slots, plist):
        nonlocal toks
        eng = new_engine(cfg, params, forward, slots)
        for i, p in enumerate(plist):
            eng.submit(Request(id=i, prompt=p, max_new_tokens=SERVE_NEW))
        active = torch.ones(slots, dtype=torch.bool, device=eng.device)
        with torch.no_grad():
            eng._admit()  # one admission prefill of all the prompts
            rows = [eng._last_logits.clone()]
            if toks is None:
                toks = [rows[0].argmax(-1, keepdim=True).to(torch.int32)]
            for j in range(REPLAY_STEPS):
                t_eff = length_bucket(max(lens) + j + 1, SERVE_MAX_LEN,
                                      base=64)
                rows.append(eng._step(toks[j][:slots], active, t_eff).clone())
                if len(toks) <= j + 1:
                    toks.append(rows[-1].argmax(-1, keepdim=True)
                                .to(torch.int32))
        return eng, torch.stack(rows)  # [REPLAY_STEPS + 1, slots, V]

    eng, kern = replay(llama.forward, SLOTS, prompts)
    _, ref = replay(functools.partial(llama.forward, plain=True), SLOTS,
                    prompts)
    tk = torch.cat(toks, 1).T  # [REPLAY_STEPS + 1, SLOTS]
    err = float((kern - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    same = ref.argmax(-1) == tk
    decided = gap > 2 * tol
    _, alone = replay(llama.forward, 1, prompts[:1])
    row = {"prompt_lens": lens, "steps": REPLAY_STEPS, "max_abs_err": err,
           "max_abs_logit": float(ref.abs().max()), "tol": tol,
           "tokens_equal_plain_argmax": int(same.sum()),
           "tokens": int(same.numel()),
           "tokens_decided": int(decided.sum()),
           "decided_tokens_agree": bool(same[decided].all()),
           "min_top2_gap": float(gap.min()),
           "finite": bool(torch.isfinite(kern).all()),
           "slot0_alone_bit_equal": bool(torch.equal(alone[:, 0],
                                                     kern[:, 0])),
           "slot0_alone_max_abs_diff": float(
               (alone[:, 0] - kern[:, 0]).abs().max())}
    emit({"serving_plain_compare": row})
    if not (row["finite"] and err <= tol and row["decided_tokens_agree"]):
        raise SystemExit(f"serving kernel path disagrees with plain: {row}")

    # batched decode steps of the kernel engine (8 live slots): untraced
    # step time, then a profiled window
    state = {"logits": kern[-1], "j": 0}
    active = torch.ones(SLOTS, dtype=torch.bool, device=eng.device)

    def one_step():
        tok = state["logits"].argmax(-1, keepdim=True).to(torch.int32)
        state["j"] += 1
        t_eff = length_bucket(max(lens) + REPLAY_STEPS + state["j"],
                              SERVE_MAX_LEN, base=64)
        with torch.no_grad():
            state["logits"] = eng._step(tok, active, t_eff)

    lat = []
    for i in range(12):  # 4 warm-up steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        if i >= 4:
            lat.append(time.perf_counter() - t0)
    prof = profile_steps(one_step, 4)
    step_ms = statistics.median(lat) * 1e3
    dev_ms = prof["device_ms_per_step"]
    prof["untraced_step_ms_median"] = step_ms
    prof["device_idle_share"] = (1.0 - dev_ms / step_ms
                                 if isinstance(dev_ms, float)
                                 else "not measured")
    emit({"serving_decode_profile": prof})
    return err, prof


def http_check(eng, cfg):
    """Three concurrent /v1/generate requests through EngineServer on port
    0; each must answer with its tokens and no error; /v1/stats and
    /health must answer."""
    import threading
    import urllib.request

    from ggmlsharp_tpu_torch.serving import EngineServer

    prompts = serving_prompts(cfg)[:3]
    n_new = 8
    srv = EngineServer(eng, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"

    def call(path, obj=None):
        data = None if obj is None else json.dumps(obj).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + path, data=data), timeout=300) as r:
            return json.loads(r.read())

    try:
        outs = [None] * len(prompts)

        def hit(i):
            outs[i] = call("/v1/generate", {"prompt": prompts[i],
                                            "max_new_tokens": n_new})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        seconds = time.perf_counter() - t0
        health = call("/health")
        st = call("/v1/stats")
    finally:
        srv.stop()
    res = {"requests": len(prompts), "seconds": seconds,
           "tokens": [o and o["tokens"] for o in outs], "health": health,
           "stats_tokens_emitted": st.get("tokens_emitted")}
    emit({"http_check": res})
    if any(o is None or o["error"] is not None or len(o["tokens"]) != n_new
           for o in outs) or health != {"ok": True} or "ticks" not in st:
        raise SystemExit(f"HTTP check failed: {res}")
    return res


def time_q4_0(dev, gen, counts):
    """Cold-L2 kernel, plain and library (bf16 torch.matmul against the
    weight dequantized to bf16) times at each shape, b in {1, 16}."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import q4_0_matmul
    from ggmlsharp_tpu_torch.models.llama import random_q4_0
    from ggmlsharp_tpu_torch.ops import mul_mat_q
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    rows = []
    for name, n, k, per_tok in Q4_SHAPES:
        copies = max(2, -(-4 * L2_BYTES // (n * k * 18 // 32)))
        ws = [random_q4_0(n, k, gen, dev) for _ in range(copies)]
        wb = [dequantize(w).to(torch.bfloat16) for w in ws]
        for b in (1, 16):
            x = torch.randn((b, k), generator=gen, device=dev)
            xb = x.to(torch.bfloat16)
            reps = 50
            kern = time_ms(lambda i: q4_0_matmul(x, ws[i % copies]["qs"],
                                                 ws[i % copies]["d"]), reps)
            plain = time_ms(lambda i: mul_mat_q(ws[i % copies], x,
                                                quantize_acts=False), 10)
            lib = time_ms(lambda i: torch.matmul(xb, wb[i % copies].T), reps)
            bound, by = q4_bound_ms(b, n, k, q8_acts=name != "output")
            rows.append({"shape": name, "b": b, "n": n, "k": k, "ms": kern,
                         "plain_ms": plain, "library_ms": lib,
                         "bound_ms": bound, "bound_by": by,
                         "roofline_share": bound / kern,
                         "launches_per_token": per_tok if b == 1 else 0})
        del ws, wb
        torch.cuda.empty_cache()
    emit({"q4_0_timing": rows})
    # one decode token: 32 x (wqkv, wo, w_gate_up, w_down) + LM head at b = 1
    dec = [r for r in rows if r["b"] == 1]
    tot = {key: sum(r[key] * r["launches_per_token"] for r in dec)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": "matmul_q4_0", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/matmul_q4_0.cu",
            "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:377",
            "launches": counts["matmul_q4_0"], **tot, "bound_by": "bytes",
            "unit": "one decode token: the 129 b=1 launches, cold L2"}


def time_flash(dev, gen, counts):
    """The main path's prefill call (warm: the rows were just written)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.flash import _cached_ref, flash_attention_cached

    _, B, Hq, Hkv, S, T, Ta, D, npast, _ = FLASH_CASES[0]
    q = torch.randn((B, Hq, S, D), generator=gen, device=dev)
    kc = torch.randn((B, Hkv, Ta, D), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((B, Hkv, Ta, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = kc[:, :, :T], vc[:, :, :T]
    np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
    qpos = torch.arange(S, device=dev)[:, None] + npast[0]
    mask = torch.arange(T, device=dev)[None, :] <= qpos  # [S, T], True = keep
    k32, v32 = k.float(), v.float()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kern = time_ms(lambda i: flash_attention_cached(q, k, v, np_t), 200)
    plain = time_ms(lambda i: _cached_ref(q, k, v, np_t, D ** -0.5), 50)
    lib = time_ms(lambda i: sdpa(q, k32, v32, attn_mask=mask), 200)
    bound, by = flash_bound_ms(B, Hq, Hkv, S, D, npast, 2)
    row = {"name": "flash_attn", "route": "cuda",
           "source": "ggmlsharp_tpu_torch/csrc/flash_attn.cu",
           "replaces": "ggmlsharp_tpu/kernels/flash.py:104",
           "launches": counts["flash_attn"], "ms": kern, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "library_ms": lib,
           "unit": "one prefill launch: B=1 Hq=32 S=16 T=256 D=128 bf16 KV"}
    emit({"flash_timing": row})
    return row


def attn_decode_bound_ms(B, Hq, Hkv, D, npast):
    """Bytes: the live int8 K/V rows and their scales, the fresh rows, q and
    out, once each; operations: 4 * Hq * D f32 flops a live key a slot."""
    rows = sum(npast)
    bytes_ = (2 * rows * Hkv * D + 2 * rows * Hkv * 4 + 2 * B * Hkv * D * 4
              + 2 * B * Hq * D * 4)
    flops = 4 * Hq * D * (rows + B)
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_attn_decode(dev, gen, counts):
    """Cold-L2 kernel, plain and library times of one decode-step layer call
    at B = SLOTS, Hq = Hkv = 32, D = 128, INT8 cache, every slot at
    npast = T - 1, for T = 64 (the serving path's bucket), 256 and 2048.
    The library time is scaled_dot_product_attention over a bf16
    head-major copy of the dequantized live rows and the fresh row, the
    call alone (the copy is made before timing)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import _decode_ref, _dequant, flash_decode_flat

    B, Hq, Hkv, D = SLOTS, 32, 32, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for T in ATTN_TIMING_T:
        live = B * T * Hkv * D * 2
        copies = max(2, -(-4 * L2_BYTES // live))
        q, kn, vn, caches = decode_inputs(dev, gen, B, Hq, Hkv, T, "int8",
                                          copies)
        npast = [T - 1] * B
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)

        def kern(i):
            kc, vc, sc = caches[i % copies]
            return flash_decode_flat(q, kn, vn, kc, vc, np_t, Hkv, D, **sc)

        def plain(i):
            kc, vc, sc = caches[i % copies]
            return _decode_ref(q, kn, vn, kc, vc, np_t, Hkv, D, **sc)

        heads = []
        for kc, vc, sc in caches:
            kv = []
            for rows_, s, new in ((kc, sc["k_scale"], kn), (vc, sc["v_scale"], vn)):
                d = _dequant(rows_[:, :T - 1], s[:, :T - 1], Hkv)
                d = torch.cat([d, new[:, None]], 1)  # the fresh row last
                kv.append(d.reshape(B, T, Hkv, D).transpose(1, 2)
                          .to(torch.bfloat16).contiguous())
            heads.append(kv)
        qb = q[:, :, None].to(torch.bfloat16)
        kern_ms = time_ms(kern, 100)
        plain_ms = time_ms(plain, 20)
        lib_ms = time_ms(lambda i: sdpa(qb, *heads[i % copies]), 100)
        bound, by = attn_decode_bound_ms(B, Hq, Hkv, D, npast)
        rows.append({"T": T, "ms": kern_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                     "roofline_share": bound / kern_ms})
        del caches, heads
        torch.cuda.empty_cache()
    emit({"attn_decode_timing": rows})
    r = rows[0]
    return {"name": "attn_decode", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/attn_decode.cu",
            "replaces": "ggmlsharp_tpu/kernels/attn_decode.py:108",
            "launches": counts["attn_decode"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "unit": "one decode-step layer call: B=8 Hq=Hkv=32 D=128 T=64 "
                    "int8 KV, npast 63, cold L2; library = SDPA alone on a "
                    "bf16 head-major copy"}


def q8_bound_ms(b, n, k, q8_acts):
    """Bytes: Q8_0 weight (34 B a 32-weight block), x and y once each.
    Operations: 2*b*n*k, int8 x int8 on the tensor cores after the Q8_0
    activation round trip, f32 FMAs when x stays f32 (the LM head)."""
    bytes_ = n * k * 34 // 32 + b * k * 4 + b * n * 4
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = 2 * b * n * k / (INT8_OP_S if q8_acts else F32_FLOP_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_q8_0(dev, gen):
    """Kernel 4 (through its wrapper) vs plain at every GPT-2 124M and 774M
    shape and one ragged one (K/32 no multiple of 8), b in {1, 8, 16, 64}.
    Tolerance: the two sum K f32 products in different orders; allow 1e-5
    of sum_k |x_k w_nk| (2^-24 is 6e-8 a rounding). Then whether a row's
    result is bit for bit the same at every b."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused, q8_0_matmul
    from ggmlsharp_tpu_torch.models.gpt2 import random_q8_0
    from ggmlsharp_tpu_torch.ops import mul_mat_q
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    worst, rows = 0.0, []
    shapes = [(f"{tag}_{name}", n, k) for tag, cfg in gpt2_configs()
              for name, n, k in gpt2_shapes(cfg.n_embd)]
    for name, n, k in shapes + [("ragged", 100, 352)]:
        w = random_q8_0(n, k, gen, dev)
        wabs = dequantize(w).abs()
        for b in (1, 8, 16, 64):
            x = torch.randn((b, k), generator=gen, device=dev)
            qa = not name.endswith("wte")  # the LM head skips the round trip
            got = mul_mat_q_fused(w, x, quantize_acts=qa)
            want = mul_mat_q(w, x, quantize_acts=qa)
            scale = x.abs() @ wabs.T
            err = (got - want).abs()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= 1e-5 * scale).all())
            e = float(err.max())
            worst = max(worst, e)
            rows.append({"shape": name, "b": b, "n": n, "k": k,
                         "max_abs_err": e,
                         "max_err_over_sum_abs": float((err / scale).max()),
                         "ok": ok})
            if not ok:
                emit({"q8_0_check": rows})
                raise SystemExit(f"Q8_0 kernel disagrees at {name} b={b}")
        del w, wabs
    w = random_q8_0(2304, 768, gen, dev)
    x = torch.randn((64, 768), generator=gen, device=dev)
    y = q8_0_matmul(x, w["qs"], w["d"])
    same = all(torch.equal(y[:b], q8_0_matmul(x[:b].contiguous(), w["qs"],
                                              w["d"])) for b in (1, 8, 16))
    emit({"q8_0_check": rows, "rows_independent_of_b": same})
    if not same:
        raise SystemExit("a Q8_0 row's result depends on b")
    return worst


def mlp_inputs(E, gen, dev, copies=1):
    """``copies`` random (W1, b1, W2, b2) of a GPT-2 MLP of width E."""
    import torch

    from ggmlsharp_tpu_torch.models.gpt2 import random_q8_0

    out = []
    for _ in range(copies):
        b1 = (torch.randn(4 * E, generator=gen, device=dev) * 0.1).bfloat16()
        b2 = (torch.randn(E, generator=gen, device=dev) * 0.1).bfloat16()
        out.append((random_q8_0(4 * E, E, gen, dev), b1,
                    random_q8_0(E, 4 * E, gen, dev), b2))
    return out


def check_mlp_fused(dev, gen):
    """Kernel 8 vs plain _ff_ref at both widths, rows in {1, 16, 64}, with
    and without the Q8_0 round trip of the input (made by the same PyTorch
    code on both sides). Tolerance: f32 summation order through two chained
    products: h may differ by 1e-5 of s1 = sum |x w1| (GELU's slope is at
    most 1.13), so y by 1e-5 of (1.13 s1 + |h|) |W2|^T."""
    import torch

    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_ref, flash_ff_q8
    from ggmlsharp_tpu_torch.ops import gelu, mul_mat_q
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    worst, rows = 0.0, []
    for tag, cfg in gpt2_configs():
        E = cfg.n_embd
        ((w1, b1, w2, b2),) = mlp_inputs(E, gen, dev)
        w1abs, w2abs = dequantize(w1).abs(), dequantize(w2).abs()
        for n_rows in (1, 16, 64):
            x = torch.randn((n_rows, E), generator=gen, device=dev)
            for qa in (False, True):
                got = flash_ff_q8(w1, b1, w2, b2, x, quantize_acts=qa)
                want = _ff_ref(w1, b1, w2, b2, x, quantize_acts=qa)
                h = gelu(mul_mat_q(w1, x, quantize_acts=qa) + b1)
                scale = (1.13 * (x.abs() @ w1abs.T) + h.abs()) @ w2abs.T
                err = (got - want).abs()
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= 1e-5 * scale).all())
                e = float(err.max())
                worst = max(worst, e)
                rows.append({"config": tag, "rows": n_rows,
                             "quantize_acts": qa, "max_abs_err": e, "ok": ok})
                if not ok:
                    emit({"mlp_fused_check": rows})
                    raise SystemExit(f"mlp_fused_q8 disagrees: {rows[-1]}")
    emit({"mlp_fused_check": rows})
    return worst


def gpt2_blocks(cfg, n, seed):
    """n random GPT-2 blocks of cfg's width (non-trivial gains and biases)."""
    import dataclasses

    from ggmlsharp_tpu_torch.models import gpt2

    small = dataclasses.replace(cfg, n_layer=n, n_vocab=256)
    return gpt2.synthetic_q8_0_params(small, seed)["blocks"]


def check_gpt2_layer(dev, gen):
    """Kernel 11 vs plain _layer_ref at both widths, T in {256, 1024}, npast
    in {0, 1, T/2, T - 1} over a bf16 cache, and one f32-cache case.
    Tolerance (all f32, values of magnitude ~4): y through five chained
    products and an online softmax 5e-5 + 5e-5 |want|; k_new, v_new (one
    product after the layer norm) 2e-5 + 2e-5 |want|. One wrong or missing
    cache row would move y by ~1e-3."""
    import torch

    from ggmlsharp_tpu_torch.kernels.gpt2_layer import _layer_ref, gpt2_layer_step

    worst, rows = 0.0, []
    for tag, cfg in gpt2_configs():
        E = cfg.n_embd
        blk = gpt2_blocks(cfg, 1, SEED + 1)[0]
        cases = [(torch.bfloat16, T, n) for T in (256, 1024)
                 for n in (0, 1, T // 2, T - 1)] + [(torch.float32, 256, 100)]
        for dt, T, npast in cases:
            kc = torch.randn((1024, E), generator=gen, device=dev).to(dt)
            vc = torch.randn((1024, E), generator=gen, device=dev).to(dt)
            x = torch.randn((1, E), generator=gen, device=dev)
            np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
            args = (blk, x, kc[:T], vc[:T], np_t, cfg.n_head, cfg.ln_eps)
            got, want = gpt2_layer_step(*args), _layer_ref(*args)
            torch.cuda.synchronize()
            errs, ok = [], True
            for g, w, tol in zip(got, want, (5e-5, 2e-5, 2e-5)):
                err = (g - w).abs()
                ok = ok and bool(torch.isfinite(g).all()) and bool(
                    (err <= tol + tol * w.abs()).all())
                errs.append(float(err.max()))
            worst = max(worst, errs[0])
            rows.append({"config": tag, "cache": str(dt), "T": T,
                         "npast": npast, "max_abs_err_y": errs[0],
                         "max_abs_err_k_new": errs[1],
                         "max_abs_err_v_new": errs[2], "ok": ok})
            if not ok:
                emit({"gpt2_layer_check": rows})
                raise SystemExit(f"gpt2_layer disagrees: {rows[-1]}")
    emit({"gpt2_layer_check": rows})
    return worst


def run_gpt2_path(tag, cfg, params, prompt):
    """sampling.generate of GPT-2 through the kernels, counters reset just
    before and read just after."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import gpt2, sampling

    cache = gpt2.new_cache(cfg, 1)
    if not cache.is_flat or cache.int8:
        raise SystemExit("GPT-2 at batch 1 must take the flat float cache")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks, cache = sampling.generate(gpt2.forward, cfg, params, prompt, cache,
                                    N_NEW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    L = cfg.n_layer
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "gpt2_layer": L * N_NEW,           # one a block a decode step
        "mlp_fused_q8": L,                 # the prefill's 16 rows
        "flash_attn": L,                   # prefill only
        # prefill: c_attn, c_proj a block + LM head; a decode step: LM head
        "matmul_q8_0": 2 * L + 1 + N_NEW}
    emit({"gpt2_path": {"config": tag, "tokens": toks[0].tolist(),
                        "seconds": seconds, "launches": counts,
                        "expected_launches": want}})
    if counts != want:
        raise SystemExit(f"GPT-2 {tag} launch counts {counts} != {want}")
    if toks.shape != (1, N_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.n_vocab:
        raise SystemExit(f"bad tokens {toks}")
    if int(cache.length[0]) != PROMPT_LEN + N_NEW:
        raise SystemExit("cache length is wrong")
    # a stream that repeats one token would leave the token checks below
    # a single argmax to compare
    if len(set(toks[0].tolist())) < N_NEW // 2:
        raise SystemExit(f"GPT-2 {tag}: the greedy stream collapsed: {toks}")
    return toks, counts


def time_q8_0(dev, gen):
    """Cold-L2 kernel, plain and library (bf16 torch.matmul against the
    weight dequantized to bf16) times at each GPT-2 shape, b in {1, 16}.
    On the path: c_attn, c_proj and wte at b = 16 (prefill), wte at b = 1
    (every decode step)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import q8_0_matmul
    from ggmlsharp_tpu_torch.models.gpt2 import random_q8_0
    from ggmlsharp_tpu_torch.ops import mul_mat_q
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    rows = []
    for tag, cfg in gpt2_configs():
        for name, n, k in gpt2_shapes(cfg.n_embd):
            copies = max(2, -(-4 * L2_BYTES // (n * k * 34 // 32)))
            reps = max(64, copies)  # every copy is touched between two reads
            ws = [random_q8_0(n, k, gen, dev) for _ in range(copies)]
            wb = [dequantize(w).to(torch.bfloat16) for w in ws]
            for b in (1, 16):
                x = torch.randn((b, k), generator=gen, device=dev)
                xb = x.to(torch.bfloat16)
                kern = time_ms(lambda i: q8_0_matmul(
                    x, ws[i % copies]["qs"], ws[i % copies]["d"]), reps)
                plain = time_ms(lambda i: mul_mat_q(
                    ws[i % copies], x, quantize_acts=False), 8)
                lib = time_ms(lambda i: torch.matmul(xb, wb[i % copies].T),
                              reps)
                bound, by = q8_bound_ms(b, n, k, q8_acts=name != "wte")
                on_path = (b == 16 and name in ("c_attn", "c_proj", "wte")) \
                    or (b == 1 and name == "wte")
                rows.append({"config": tag, "shape": name, "b": b, "n": n,
                             "k": k, "ms": kern, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bound,
                             "bound_by": by, "roofline_share": bound / kern,
                             "cold_copies": copies, "on_path": on_path})
            del ws, wb
            torch.cuda.empty_cache()
    emit({"q8_0_timing": rows})
    r = next(r for r in rows if r["config"] == "124M" and r["shape"] == "wte"
             and r["b"] == 1)
    return {"name": "matmul_q8_0", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/matmul_q8_0.cu",
            "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:572",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "unit": "one decode token of GPT-2 124M: the LM head launch "
                    "(50257 x 768, b=1, f32 x), cold L2; library = bf16 "
                    "torch.matmul"}


def mlp_bound_ms(B, E):
    """Bytes: both Q8_0 weights, x and y once each (h is no tensor of the
    model). Operations: the first product is int8 x int8 after the input's
    Q8_0 round trip, the second f32 x int8 (h is never quantized)."""
    F = 4 * E
    bytes_ = 2 * F * E * 34 // 32 + 2 * B * E * 4 + (F + E) * 2
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = 2 * B * F * E / INT8_OP_S + 2 * B * E * F / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_mlp_fused(dev, gen):
    """Cold-L2 kernel, plain and library times of the prefill's MLP call
    (16 rows) at both widths. Library: two bf16 torch.matmuls around
    F.gelu(approximate="tanh") over weights dequantized to bf16."""
    import torch
    import torch.nn.functional as F_

    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_ref, mlp_fused_q8
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    rows = []
    for tag, cfg in gpt2_configs():
        E = cfg.n_embd
        copies = max(2, -(-4 * L2_BYTES // (8 * E * E * 34 // 32)))
        ws = mlp_inputs(E, gen, dev, copies)
        wb = [(dequantize(w1).bfloat16(), dequantize(w2).bfloat16())
              for w1, _, w2, _ in ws]
        x = torch.randn((PROMPT_LEN, E), generator=gen, device=dev)
        xb = x.bfloat16()

        def lib(i):
            (w1, w2), (_, b1, _, b2) = wb[i % copies], ws[i % copies]
            return F_.gelu(xb @ w1.T + b1, approximate="tanh") @ w2.T + b2

        def kern(i):
            w1, b1, w2, b2 = ws[i % copies]
            return mlp_fused_q8(x, w1, b1, w2, b2)

        def plain(i):
            return _ff_ref(*ws[i % copies], x, quantize_acts=False)

        bound, by = mlp_bound_ms(PROMPT_LEN, E)
        ms = time_ms(kern, 64)
        rows.append({"config": tag, "rows": PROMPT_LEN, "ms": ms,
                     "plain_ms": time_ms(plain, 8),
                     "library_ms": time_ms(lib, 64), "bound_ms": bound,
                     "bound_by": by, "roofline_share": bound / ms,
                     "cold_copies": copies})
        del ws, wb
        torch.cuda.empty_cache()
    emit({"mlp_fused_timing": rows})
    r = rows[0]
    return {"name": "mlp_fused_q8", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/mlp_fused_q8.cu",
            "replaces": "ggmlsharp_tpu/kernels/mlp_fused.py:130",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "unit": "one prefill MLP call of GPT-2 124M: 16 rows, E 768, "
                    "F 3072, cold L2; library = two bf16 torch.matmuls + "
                    "F.gelu"}


def layer_bound_ms(E, npast):
    """Bytes: the four Q8_0 weights, the live bf16 K/V rows, biases and
    gains, x, y, k_new, v_new once each. Operations: f32 FMAs of the four
    products and of attention over the live rows."""
    bytes_ = 12 * E * E * 34 // 32 + 2 * npast * E * 2 + 13 * E * 2 + 16 * E
    flops = 2 * 12 * E * E + 4 * (npast + 1) * E
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_gpt2_layer(dev, gen):
    """Cold-L2 kernel and plain times of one decode step's block call at both
    widths: T 256 (the path's bucket), npast 32 (the path's steps run 16 to
    47), bf16 cache; each call a different block's weights, as a decode step
    walks the layers. No single PyTorch call computes a whole block:
    library_ms is null."""
    import torch

    from ggmlsharp_tpu_torch.kernels.gpt2_layer import _layer_ref, gpt2_layer_step

    rows, T, npast = [], 256, 32
    for tag, cfg in gpt2_configs():
        E = cfg.n_embd
        copies = max(2, -(-4 * L2_BYTES // (12 * E * E * 34 // 32)))
        blocks = gpt2_blocks(cfg, copies, SEED + 2)
        kc = torch.randn((T, E), generator=gen, device=dev).bfloat16()
        vc = torch.randn((T, E), generator=gen, device=dev).bfloat16()
        x = torch.randn((1, E), generator=gen, device=dev)
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)

        def kern(i):
            return gpt2_layer_step(blocks[i % copies], x, kc, vc, np_t,
                                   cfg.n_head, cfg.ln_eps)

        def plain(i):
            return _layer_ref(blocks[i % copies], x, kc, vc, np_t,
                              cfg.n_head, cfg.ln_eps)

        bound, by = layer_bound_ms(E, npast)
        ms = time_ms(kern, 2 * copies)
        rows.append({"config": tag, "T": T, "npast": npast, "ms": ms,
                     "plain_ms": time_ms(plain, 8), "library_ms": None,
                     "bound_ms": bound, "bound_by": by,
                     "roofline_share": bound / ms, "cold_copies": copies})
        del blocks
        torch.cuda.empty_cache()
    emit({"gpt2_layer_timing": rows})
    r = rows[0]
    return {"name": "gpt2_layer", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/gpt2_layer.cu",
            "replaces": "ggmlsharp_tpu/kernels/gpt2_layer.py:131",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "unit": "one block call of a GPT-2 124M decode step: E 768, "
                    "12 heads, T 256, npast 32, bf16 KV, cold L2; no "
                    "library call computes a block"}


def llama_blocks(cfg, n, seed, gen, dev):
    """n random llama blocks of cfg's widths with both fused routes packed
    and non-trivial f32 gains for the whole-block route."""
    import dataclasses

    import torch

    from ggmlsharp_tpu_torch.models import llama

    small = dataclasses.replace(cfg, n_layer=n, n_vocab=256)
    blocks = llama.synthetic_q4_0_params(small, seed, mlp_fused=True,
                                         layer_fused=True)["blocks"]
    for blk in blocks:
        for key in ("g1", "g2"):
            blk["layer_fused"][key] = 1.0 + 0.1 * torch.randn(
                cfg.n_embd, generator=gen, device=dev)
    return small, blocks


def check_mlp_fused_silu(dev, gen):
    """Kernel 9 vs plain _ff_silu_ref at Llama-7B's E and F, rows in {1, 8,
    16}, with and without the Q8_0 round trip of the input (made by the same
    PyTorch code on both sides). Tolerance: f32 summation order through two
    chained products. g and u may each differ by 1e-5 of their s = sum |x w|;
    silu's slope is at most 1.1 and |silu(g)| <= |g|, so the gated product a
    by 1e-5 of (1.1 |u| s_g + |g| s_u), and y by 1e-5 of that plus |a|,
    through |W2|^T. That bound sums 15000 magnitudes and is far above what
    random rounding leaves (measured 7e-10 of it), so y is also held to 5e-5
    + 5e-5 |want| (measured 4.6e-6 on values up to 3.3): a dropped quant
    block would move y by ~1e-2."""
    import torch

    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_silu_ref, flash_ff_silu_q4
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.ops import mul_mat_q, silu
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    cfg = llama.LLAMA_7B
    E, F = cfg.n_embd, cfg.n_ff
    w1 = llama.random_q4_0(2 * F, E, gen, dev)
    w2 = llama.random_q4_0(E, F, gen, dev)
    w1abs, w2abs = dequantize(w1).abs(), dequantize(w2).abs()
    worst, rows = 0.0, []
    for n_rows in (1, SLOTS, PROMPT_LEN):
        x = torch.randn((n_rows, E), generator=gen, device=dev)
        for qa in (False, True):
            got = flash_ff_silu_q4(w1, w2, x, quantize_acts=qa)
            want = _ff_silu_ref(w1, w2, x, quantize_acts=qa)
            gu = mul_mat_q(w1, x, quantize_acts=qa)
            g, u = gu[:, :F], gu[:, F:]
            s1 = x.abs() @ w1abs.T
            scale = (1.1 * u.abs() * s1[:, :F] + g.abs() * s1[:, F:]
                     + (silu(g) * u).abs()) @ w2abs.T
            err = (got - want).abs()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= 1e-5 * scale).all()) and bool(
                (err <= 5e-5 + 5e-5 * want.abs()).all())
            e = float(err.max())
            worst = max(worst, e)
            rows.append({"rows": n_rows, "quantize_acts": qa,
                         "max_abs_err": e, "max_abs": float(want.abs().max()),
                         "max_err_over_scale": float((err / scale).max()),
                         "ok": ok})
            if not ok:
                emit({"mlp_fused_silu_check": rows})
                raise SystemExit(f"mlp_fused_silu_q4 disagrees: {rows[-1]}")
    emit({"mlp_fused_silu_check": rows})
    return worst


# whole-block check shapes: (label, n_head_kv, n_ff, rope mode)
LAYER_SHAPES = [("7b_mha", 32, 11008, 0), ("7b_mha_neox", 32, 11008, 2),
                # Mistral-7B's block: GQA n_rep 4, F 14336 (57 KB of shared
                # memory for the gated product: over the 48 KB default)
                ("gqa4_f14336", 8, 14336, 0)]
LAYER_TOL = (5e-5, 2e-5, 2e-5)  # y, k_new, v_new: tol + tol * |want|


def check_llama_layer(dev, gen):
    """Kernel 10 vs plain _layer_ref at Llama-7B's block (MHA, D 128), rope
    modes 0 and 2, and at one GQA shape; T 256 with npast in {0, 32, T - 1}
    over a bf16 cache, npast 100 over an f32 cache, and T 2048 at npast
    2047. Tolerance (all f32, values of magnitude ~4; gpt2_layer's bars): y
    through five chained products of K up to 14336 and an online softmax
    5e-5 + 5e-5 |want| (measured 1.7e-6); k_new, v_new (one product after
    the norm, k rotated) 2e-5 + 2e-5 |want| (measured 9.5e-7). One wrong or
    missing cache row would move y by ~1e-3."""
    import dataclasses

    import torch

    from ggmlsharp_tpu_torch.kernels.llama_layer import _layer_ref, llama_layer_step
    from ggmlsharp_tpu_torch.models import llama

    worst, rows = 0.0, []
    for label, hkv, n_ff, mode in LAYER_SHAPES:
        cfg = dataclasses.replace(llama.LLAMA_7B, n_head_kv=hkv, n_ff=n_ff,
                                  rope_mode=mode)
        cfg, (blk,) = llama_blocks(cfg, 1, SEED + 1, gen, dev)
        Ekv = cfg.n_head_kv * cfg.head_dim
        cases = [(torch.bfloat16, 256, n) for n in (0, 32, 255)] \
            + [(torch.float32, 256, 100), (torch.bfloat16, 2048, 2047)]
        for dt, T, npast in cases:
            kc = torch.randn((2048, Ekv), generator=gen, device=dev).to(dt)
            vc = torch.randn((2048, Ekv), generator=gen, device=dev).to(dt)
            x = torch.randn((1, cfg.n_embd), generator=gen, device=dev)
            np_t = torch.tensor([npast], dtype=torch.int32, device=dev)
            args = (blk, x, kc[:T], vc[:T], np_t, cfg)
            got, want = llama_layer_step(*args), _layer_ref(*args)
            torch.cuda.synchronize()
            errs, ok = [], True
            for g, w, tol in zip(got, want, LAYER_TOL):
                err = (g - w).abs()
                ok = ok and bool(torch.isfinite(g).all()) and bool(
                    (err <= tol + tol * w.abs()).all())
                errs.append(float(err.max()))
            worst = max(worst, errs[0])
            rows.append({"shape": label, "cache": str(dt), "T": T,
                         "npast": npast, "max_abs_err_y": errs[0],
                         "max_abs_err_k_new": errs[1],
                         "max_abs_err_v_new": errs[2],
                         "max_abs_y": float(want[0].abs().max()), "ok": ok})
            if not ok:
                emit({"llama_layer_check": rows})
                raise SystemExit(f"llama_layer disagrees: {rows[-1]}")
        del blk
        torch.cuda.empty_cache()
    emit({"llama_layer_check": rows})
    return worst


ATTN_LAYOUT_CASES = [  # (label, B, Hq, Hkv, T, npast a slot), D 128, bf16
    ("attn_mha_T64", SLOTS, 32, 32, 64, [0, 63, 5, 17, 40, 1, 62, 33]),
    ("attn_mha_T2048", SLOTS, 32, 32, 2048,
     [0, 2047, 100, 1000, 1500, 7, 2046, 512]),
    ("attn_gqa4_T2048", SLOTS, 32, 8, 2048,
     [0, 2047, 100, 1000, 1500, 7, 2046, 512]),
]


def check_attn_layout(dev, gen):
    """Kernel 3 with the "attn" lane map vs its plain version (permute to
    element order, _decode_ref, permute back): rtol 2e-4 / atol 2e-5, as for
    the heads map."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import (_decode_ref_attn,
                                                         flash_decode_flat_attn)

    worst, rows = 0.0, []
    for label, B, Hq, Hkv, T, npast in ATTN_LAYOUT_CASES:
        q, kn, vn, ((kc, vc, _),) = decode_inputs(dev, gen, B, Hq, Hkv, T,
                                                  "bf16")
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
        args = (q.reshape(B, Hq * 128), kn, vn, kc, vc, np_t, Hq, Hkv, 128)
        got, want = flash_decode_flat_attn(*args), _decode_ref_attn(*args)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= 2e-5 + 2e-4 * want.abs()).all())
        e = float(err.max())
        worst = max(worst, e)
        rows.append({"case": label, "max_abs_err": e, "ok": ok})
        if not ok:
            emit({"attn_layout_check": rows})
            raise SystemExit(f"attn_decode (attn lane map) disagrees in "
                             f"case {label}")
    emit({"attn_layout_check": rows})
    return worst


def strip_routes(params, keys):
    """The same tree (tensors shared) without the fused routes' block
    entries named in ``keys``."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: v for k, v in blk.items() if k not in keys}
                     for blk in params["blocks"]]
    return out


def run_fused_path(cfg, params, prompt, label, n_new, want,
                   tag="llama_fused_path", **cache_kw):
    """sampling.generate of Llama through a fused route (or, paths e and f,
    a weight format), counters reset just before and read just after;
    ``want``: the launches expected; ``tag``: the printed row's key."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import llama, sampling

    cache = llama.new_cache(cfg, 1, **cache_kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks, cache = sampling.generate(llama.forward, cfg, params, prompt, cache,
                                    n_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    want = dict.fromkeys(kernels.LAUNCHES, 0) | want
    emit({tag: {"route": label, "tokens": toks[0].tolist(),
                "seconds": seconds, "launches": counts,
                "expected_launches": want}})
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts} != {want}")
    if toks.shape != (1, n_new) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.n_vocab:
        raise SystemExit(f"bad tokens {toks}")
    if int(cache.length[0]) != PROMPT_LEN + n_new:
        raise SystemExit("cache length is wrong")
    return toks, counts


def mlp_silu_bound_ms(B, E, F):
    """Bytes: both Q4_0 weights (18 B a 32-weight block), x and y once each
    (the gated product is no tensor of the model). Operations: the gate/up
    product is int8 x int4 after the input's Q8_0 round trip, the down
    product f32 x int4 (the gated product is never quantized)."""
    bytes_ = 3 * E * F * 18 // 32 + 2 * B * E * 4
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = 4 * B * F * E / INT8_OP_S + 2 * B * E * F / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_mlp_fused_silu(dev, gen):
    """Cold-L2 kernel, plain and library times of one Llama-7B MLP call at 1
    row (a decode step), 8 (a serving step) and 16 (the prompt). Library: two
    bf16 torch.matmuls around F.silu over weights dequantized to bf16."""
    import torch
    import torch.nn.functional as F_

    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_silu_ref, mlp_fused_silu_q4
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    cfg = llama.LLAMA_7B
    E, F = cfg.n_embd, cfg.n_ff
    copies = max(2, -(-4 * L2_BYTES // (3 * E * F * 18 // 32)))
    ws = [(llama.random_q4_0(2 * F, E, gen, dev),
           llama.random_q4_0(E, F, gen, dev)) for _ in range(copies)]
    wb = [(dequantize(w1).bfloat16(), dequantize(w2).bfloat16())
          for w1, w2 in ws]
    rows = []
    for n_rows in (1, SLOTS, PROMPT_LEN):
        x = torch.randn((n_rows, E), generator=gen, device=dev)
        xb = x.bfloat16()

        def lib(i):
            w1, w2 = wb[i % copies]
            gu = xb @ w1.T
            return (F_.silu(gu[:, :F]) * gu[:, F:]) @ w2.T

        bound, by = mlp_silu_bound_ms(n_rows, E, F)
        ms = time_ms(lambda i: mlp_fused_silu_q4(x, *ws[i % copies]), 48)
        rows.append({"rows": n_rows, "ms": ms,
                     "plain_ms": time_ms(lambda i: _ff_silu_ref(
                         *ws[i % copies], x, quantize_acts=False), 6),
                     "library_ms": time_ms(lib, 48), "bound_ms": bound,
                     "bound_by": by, "roofline_share": bound / ms,
                     "cold_copies": copies})
    del ws, wb
    torch.cuda.empty_cache()
    emit({"mlp_fused_silu_timing": rows})
    r = rows[0]
    return {"name": "mlp_fused_silu_q4", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/mlp_fused_silu_q4.cu",
            "replaces": "ggmlsharp_tpu/kernels/mlp_fused.py:268",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "unit": "one Llama-7B MLP call at 1 row (a decode step): E 4096, "
                    "F 11008, cold L2; library = two bf16 torch.matmuls + "
                    "F.silu"}


def llama_layer_bound_ms(cfg, npast):
    """Bytes: the four Q4_0 weights, the live bf16 K/V rows, gains, cos/sin,
    slot, x, y, k_new, v_new once each. Operations: f32 FMAs of the four
    products and of attention over the live rows."""
    E, F = cfg.n_embd, cfg.n_ff
    Ekv = cfg.n_head_kv * cfg.head_dim
    n_w = 2 * E * E + 2 * E * Ekv + 3 * E * F
    bytes_ = n_w * 18 // 32 + 2 * npast * Ekv * 2 + 12 * E + 8 * E + 8 * Ekv \
        + 4 * cfg.head_dim
    flops = 2 * n_w + 4 * (npast + 1) * E
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_llama_layer(dev, gen):
    """Cold-L2 kernel and plain times of one decode step's block call at
    Llama-7B's block, bf16 cache: T 256 at npast 32 (path d's steps run 16 to
    47) and T 2048 at npast 2047; each call a different block's weights, as a
    decode step walks the layers (a block's 113.8 MB exceed L2 alone). cos
    and sin are made before timing, as forward makes them once a step. No
    single PyTorch call computes a whole block: library_ms is null."""
    import torch

    from ggmlsharp_tpu_torch.kernels.llama_layer import (_layer_ref,
                                                         llama_layer_step,
                                                         rope_vectors)
    from ggmlsharp_tpu_torch.models import llama

    copies = 3
    cfg, blocks = llama_blocks(llama.LLAMA_7B, copies, SEED + 2, gen, dev)
    Ekv = cfg.n_head_kv * cfg.head_dim
    kc = torch.randn((2048, Ekv), generator=gen, device=dev).bfloat16()
    vc = torch.randn((2048, Ekv), generator=gen, device=dev).bfloat16()
    x = torch.randn((1, cfg.n_embd), generator=gen, device=dev)
    rows = []
    for T, npast in ((256, 32), (2048, 2047)):
        np_t = torch.tensor([npast], dtype=torch.int32, device=dev)
        rope = rope_vectors(np_t, cfg)
        bound, by = llama_layer_bound_ms(cfg, npast)
        ms = time_ms(lambda i: llama_layer_step(
            blocks[i % copies], x, kc[:T], vc[:T], np_t, cfg, rope), 24)
        plain = time_ms(lambda i: _layer_ref(
            blocks[i % copies], x, kc[:T], vc[:T], np_t, cfg, rope), 6)
        rows.append({"T": T, "npast": npast, "ms": ms, "plain_ms": plain,
                     "library_ms": None, "bound_ms": bound, "bound_by": by,
                     "roofline_share": bound / ms, "cold_copies": copies})
    del blocks
    torch.cuda.empty_cache()
    emit({"llama_layer_timing": rows})
    r = rows[0]
    return {"name": "llama_layer", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/llama_layer.cu",
            "replaces": "ggmlsharp_tpu/kernels/llama_layer.py:213",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "unit": "one block call of a Llama-7B decode step: E 4096, 32 "
                    "heads, D 128, F 11008, T 256, npast 32, bf16 KV, cold "
                    "L2; no library call computes a block"}


def time_attn_layout(dev, gen):
    """Kernel 3's two lane maps beside each other on one bf16 cache (cold
    L2): B = SLOTS, Hq = Hkv = 32, D 128, every slot at npast = T - 1, T 64
    and 2048. The same rows are read, only their lanes are mapped otherwise,
    so both calls move the same bytes."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import (_decode_ref_attn,
                                                         flash_decode_flat,
                                                         flash_decode_flat_attn)

    B, Hq, Hkv, D = SLOTS, 32, 32, 128
    rows = []
    for T in (64, 2048):
        copies = max(2, -(-4 * L2_BYTES // (B * T * Hkv * D * 4)))
        q, kn, vn, caches = decode_inputs(dev, gen, B, Hq, Hkv, T, "bf16",
                                          copies)
        np_t = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
        qa = q.reshape(B, Hq * D)

        def attn(i):
            kc, vc, _ = caches[i % copies]
            return flash_decode_flat_attn(qa, kn, vn, kc, vc, np_t, Hq, Hkv, D)

        def heads(i):
            kc, vc, _ = caches[i % copies]
            return flash_decode_flat(q, kn, vn, kc, vc, np_t, Hkv, D)

        def plain(i):
            kc, vc, _ = caches[i % copies]
            return _decode_ref_attn(qa, kn, vn, kc, vc, np_t, Hq, Hkv, D)

        live = B * (T - 1)
        bytes_ = 2 * live * Hkv * D * 2 + 2 * B * Hkv * D * 4 \
            + 2 * B * Hq * D * 4
        rows.append({"T": T, "attn_layout_ms": time_ms(attn, 100),
                     "heads_layout_ms": time_ms(heads, 100),
                     "plain_ms": time_ms(plain, 20),
                     "bound_ms": bytes_ / HBM_BYTES_S * 1e3,
                     "bound_by": "bytes"})
        del caches
        torch.cuda.empty_cache()
    emit({"attn_layout_timing": rows})
    return rows


# --- the formats slice: kernel A (matmul_q.cu), kernel B (matmul_int_dot.cu),
# paths e (BASELINE config 3) and f (the other formats, the int-dot route) --

A_FORMATS = ("Q4_1", "Q4_2", "Q4_3", "Q5_0", "Q5_1", "Q4_K", "Q6_K")
B_FORMATS = ("Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1")
E_FORMATS = ("Q4_K", "Q6_K")  # path e: BASELINE config 3, INT8 flat cache
F_LAYERS, F_NEW = 8, 8        # path f: depth cut to bound the phase's time


def random_weight(fmt, n, k, gen, dev):
    """A random [n, k] weight of ``fmt``: N(0, 1/k) quantized on the card."""
    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.quant.quantize import quantize

    return quantize(torch.randn((n, k), generator=gen, device=dev) / k ** 0.5,
                    GType[fmt])


def weight_abs_terms(w):
    """|q·d| + |m| element by element (fused k-quant scales): the magnitudes
    a kernel adds for one weight, whatever order it adds them in."""
    import torch

    from ggmlsharp_tpu_torch.quant.formats import QTensor
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    full = dequantize(w, fused_scales=True)
    mins = [key for key in ("m", "dmin") if key in w.planes]
    if not mins:
        return full.abs()
    v = dequantize(QTensor(w.gtype, w.shape, {
        **w.planes, **{key: torch.zeros_like(w[key]) for key in mins}}),
        fused_scales=True)
    return v.abs() + (full - v).abs()


def check_matmul_q(dev, gen):
    """Kernel A (through mul_mat_q_fused) vs plain mul_mat_q for its seven
    formats at every 7B shape (K 4096 and 11008), b in {1, 16}. Tolerance:
    f32 summation order, with the min terms folded through per-block
    activation sums: 1e-5 of sum_k |x_k| (|q d| + |m|)_nk (2^-24 is 6e-8 a
    rounding). Then whether a row's result is bit for bit the same at b =
    1, 8 and 128, for each format."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused, q_matmul
    from ggmlsharp_tpu_torch.ops import mul_mat_q, quantize_activations
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    worst, rows, same = {}, [], {}
    for fmt in A_FORMATS:
        for name, n, k, _ in Q4_SHAPES:
            w = random_weight(fmt, n, k, gen, dev)
            wabs = weight_abs_terms(w)
            for b in (1, 16):
                x = torch.randn((b, k), generator=gen, device=dev)
                qa = name != "output"  # the LM head skips the round trip
                got = mul_mat_q_fused(w, x, quantize_acts=qa)
                want = mul_mat_q(w, x, quantize_acts=qa)
                xq = dequantize(quantize_activations(x, w.gtype)) if qa else x
                scale = xq.abs() @ wabs.T
                err = (got - want).abs()
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= 1e-5 * scale).all())
                e = float(err.max())
                worst[fmt] = max(worst.get(fmt, 0.0), e)
                rows.append({"format": fmt, "shape": name, "b": b, "n": n,
                             "k": k, "max_abs_err": e,
                             "max_err_over_sum_abs": float((err / scale).max()),
                             "ok": ok})
                if not ok:
                    emit({"matmul_q_check": rows})
                    raise SystemExit(f"matmul_q disagrees: {rows[-1]}")
            del w, wabs
        w = random_weight(fmt, 4096, 4096, gen, dev)
        x = torch.randn((SLOTS * 16, 4096), generator=gen, device=dev)
        y = q_matmul(x, w)
        same[fmt] = all(torch.equal(y[:b], q_matmul(x[:b].contiguous(), w))
                        for b in (1, SLOTS))
    emit({"matmul_q_check": rows, "rows_independent_of_b": same})
    if not all(same.values()):
        raise SystemExit(f"a matmul_q row's result depends on b: {same}")
    return worst


def check_int_dot(dev, gen):
    """Kernel B vs its plain _int_dot_ref for its five formats at the 7B
    shapes of a decode step's matmuls (b = 1), the same quantized
    activations on both sides. The block sums are exact integers on both;
    tolerance: f32 summation order over blocks, 1e-5 of sum_k |x_k| (|q d|
    + |m|)_nk with x the Q8 activations."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import (_int_dot_ref,
                                                      int_dot_acts,
                                                      int_dot_launch)

    worst, rows = {}, []
    for fmt in B_FORMATS:
        for name, n, k, _ in Q4_SHAPES[:4]:  # the LM head keeps f32 x
            w = random_weight(fmt, n, k, gen, dev)
            wabs = weight_abs_terms(w)
            x = torch.randn(k, generator=gen, device=dev)
            xq, da, xs = int_dot_acts(w, x)
            got = int_dot_launch(w, xq, da, xs)
            want = _int_dot_ref(w, xq, da, xs)
            scale = (xq.float() * da.repeat_interleave(32)).abs() @ wabs.T
            err = (got - want).abs()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= 1e-5 * scale).all())
            e = float(err.max())
            worst[fmt] = max(worst.get(fmt, 0.0), e)
            rows.append({"format": fmt, "shape": name, "n": n, "k": k,
                         "max_abs_err": e,
                         "max_err_over_sum_abs": float((err / scale).max()),
                         "ok": ok})
            if not ok:
                emit({"int_dot_check": rows})
                raise SystemExit(f"matmul_int_dot disagrees: {rows[-1]}")
            del w, wabs
    emit({"int_dot_check": rows})
    return worst


def quantizers_on_card(dev, gen):
    """Whether each quantizer gives on the card the wire bytes it gives on
    the CPU (the tests hold the CPU's against the JAX package), for every
    block format, and for the k-quant searches; the share of blocks that
    differ where they do not."""
    import numpy as np
    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.quant.formats import FORMATS, to_wire, wire_block_bytes
    from ggmlsharp_tpu_torch.quant.quantize import quantize

    res = {}
    x = torch.randn((256, 4096), generator=gen, device=dev)
    x[:, ::7] *= 8.0  # outliers: ties and clamps
    for g in FORMATS:
        for search in ((False, True) if g in (GType.Q4_K, GType.Q6_K)
                       else (False,)):
            a = np.frombuffer(to_wire(quantize(x, g, search=search)), np.uint8)
            b = np.frombuffer(to_wire(quantize(x.cpu(), g, search=search)),
                              np.uint8)
            bb = wire_block_bytes(g)[1]
            diff = (a.reshape(-1, bb) != b.reshape(-1, bb)).any(-1)
            res[g.name + (" search" if search else "")] = float(diff.mean())
    emit({"quantizers_card_vs_cpu_blocks_differing": res})
    return res


def wq_bound_ms(b, n, k, wbytes, q8_acts):
    """Bytes: the packed weight as the kernel reads it, x and y once each.
    Operations: 2*b*n*k; after the Q8 round trip the operands are int8 x
    int4..int6 values, which the int8 tensor cores multiply exactly; the LM
    head's x stays f32."""
    t_bytes = (wbytes + b * k * 4 + b * n * 4) / HBM_BYTES_S
    t_ops = 2 * b * n * k / (INT8_OP_S if q8_acts else F32_FLOP_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_matmul_q(dev, gen, counts):
    """Cold-L2 kernel A, plain and library (bf16 torch.matmul against the
    weight dequantized to bf16) times: Q4_K and Q6_K at every 7B shape, b in
    {1, 16}; the other formats at w_gate_up, b = 1. The row: one decode
    token of path e1 (Q4_K), its 129 b = 1 launches."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import q_matmul
    from ggmlsharp_tpu_torch.ops import mul_mat_q
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    rows = []
    for fmt in A_FORMATS:
        shapes = Q4_SHAPES if fmt in E_FORMATS else Q4_SHAPES[2:3]
        for name, n, k, per_tok in shapes:
            w0 = random_weight(fmt, n, k, gen, dev)
            wbytes = w0.nbytes()
            copies = max(2, -(-4 * L2_BYTES // wbytes))
            ws = [w0] + [random_weight(fmt, n, k, gen, dev)
                         for _ in range(copies - 1)]
            wb = [dequantize(w, fused_scales=True).to(torch.bfloat16)
                  for w in ws]
            for b in ((1, 16) if fmt in E_FORMATS else (1,)):
                x = torch.randn((b, k), generator=gen, device=dev)
                xb = x.to(torch.bfloat16)
                kern = time_ms(lambda i: q_matmul(x, ws[i % copies]),
                               max(50, copies))
                plain = time_ms(lambda i: mul_mat_q(ws[i % copies], x,
                                                    quantize_acts=False), 8)
                lib = time_ms(lambda i: torch.matmul(xb, wb[i % copies].T),
                              max(50, copies))
                bound, by = wq_bound_ms(b, n, k, wbytes, name != "output")
                rows.append({"format": fmt, "shape": name, "b": b, "n": n,
                             "k": k, "weight_bytes": wbytes, "ms": kern,
                             "plain_ms": plain, "library_ms": lib,
                             "bound_ms": bound, "bound_by": by,
                             "roofline_share": bound / kern,
                             "cold_copies": copies,
                             "launches_per_token": per_tok if b == 1 else 0})
            del ws, wb
            torch.cuda.empty_cache()
    emit({"matmul_q_timing": rows})

    def token(fmt):
        dec = [r for r in rows if r["format"] == fmt and r["b"] == 1]
        return {key: sum(r[key] * r["launches_per_token"] for r in dec)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    gu = {r["format"]: r["ms"] for r in rows
          if r["shape"] == "w_gate_up" and r["b"] == 1}
    return {"name": "matmul_q", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/matmul_q.cu",
            "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:377 (and :199, "
                        ":737)",
            "launches": counts["matmul_q"], **token("Q4_K"),
            "bound_by": "bytes", "q6_k_token": token("Q6_K"),
            "w_gate_up_b1_ms": gu,
            "unit": "one decode token of path e1 (Q4_K): the 129 b=1 "
                    "launches, cold L2; library = bf16 torch.matmul"}


def time_int_dot(dev, gen, counts):
    """Cold-L2 kernel B, plain and library (bf16 torch.matmul against the
    weight dequantized to bf16) times at w_gate_up (22016 x 4096), b = 1,
    for each of its formats; the activations quantized once before
    timing, as a call quantizes them before its launch."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import (_int_dot_ref,
                                                      int_dot_acts,
                                                      int_dot_launch)
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    _, n, k, _ = Q4_SHAPES[2]
    rows = []
    for fmt in B_FORMATS:
        w0 = random_weight(fmt, n, k, gen, dev)
        wbytes = w0.nbytes()
        copies = max(2, -(-4 * L2_BYTES // wbytes))
        ws = [w0] + [random_weight(fmt, n, k, gen, dev)
                     for _ in range(copies - 1)]
        wb = [dequantize(w).to(torch.bfloat16) for w in ws]
        x = torch.randn(k, generator=gen, device=dev)
        xq, da, xs = int_dot_acts(w0, x)
        xb = x.to(torch.bfloat16)[None]
        kern = time_ms(lambda i: int_dot_launch(ws[i % copies], xq, da, xs),
                       max(50, copies))
        plain = time_ms(lambda i: _int_dot_ref(ws[i % copies], xq, da, xs), 8)
        lib = time_ms(lambda i: torch.matmul(xb, wb[i % copies].T),
                      max(50, copies))
        act_bytes = k + k // 32 * 4 * (2 if xs is not None else 1)
        t_bytes = (wbytes + act_bytes + n * 4) / HBM_BYTES_S
        t_ops = 2 * n * k / INT8_OP_S
        bound = max(t_bytes, t_ops) * 1e3
        rows.append({"format": fmt, "n": n, "k": k, "weight_bytes": wbytes,
                     "ms": kern, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "roofline_share": bound / kern, "cold_copies": copies})
        del ws, wb
        torch.cuda.empty_cache()
    emit({"int_dot_timing": rows})
    r = next(r for r in rows if r["format"] == "Q4_0")
    return {"name": "matmul_int_dot", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/matmul_int_dot.cu",
            "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:803",
            "launches": counts["matmul_int_dot"],
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "w_gate_up_ms": {r["format"]: r["ms"] for r in rows},
            "unit": "one w_gate_up launch (22016 x 4096, b=1) of Q4_0, cold "
                    "L2; library = bf16 torch.matmul"}


def time_attn_decode_b1(dev, gen):
    """Kernel 3 at path e's shape: B = 1, Hq = Hkv = 32, D 128, INT8 cache,
    npast = T - 1, T 64 and 2048 (cold L2), beside its plain version and
    SDPA over a bf16 head-major copy of the live rows (the call alone)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import (_decode_ref, _dequant,
                                                         flash_decode_flat)

    B, Hq, Hkv, D = 1, 32, 32, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for T in (64, 2048):
        copies = max(2, -(-4 * L2_BYTES // (B * T * Hkv * D * 2)))
        q, kn, vn, caches = decode_inputs(dev, gen, B, Hq, Hkv, T, "int8",
                                          copies)
        np_t = torch.full((B,), T - 1, dtype=torch.int32, device=dev)

        def kern(i):
            kc, vc, sc = caches[i % copies]
            return flash_decode_flat(q, kn, vn, kc, vc, np_t, Hkv, D, **sc)

        def plain(i):
            kc, vc, sc = caches[i % copies]
            return _decode_ref(q, kn, vn, kc, vc, np_t, Hkv, D, **sc)

        heads = []
        for kc, vc, sc in caches:
            kv = []
            for rows_, s, new in ((kc, sc["k_scale"], kn),
                                  (vc, sc["v_scale"], vn)):
                d = torch.cat([_dequant(rows_[:, :T - 1], s[:, :T - 1], Hkv),
                               new[:, None]], 1)
                kv.append(d.reshape(B, T, Hkv, D).transpose(1, 2)
                          .to(torch.bfloat16).contiguous())
            heads.append(kv)
        qb = q[:, :, None].to(torch.bfloat16)
        bound, by = attn_decode_bound_ms(B, Hq, Hkv, D, [T - 1] * B)
        ms = time_ms(kern, 100)
        rows.append({"B": B, "T": T, "ms": ms, "plain_ms": time_ms(plain, 20),
                     "library_ms": time_ms(lambda i: sdpa(
                         qb, *heads[i % copies]), 100),
                     "bound_ms": bound, "bound_by": by,
                     "roofline_share": bound / ms, "cold_copies": copies})
        del caches, heads
        torch.cuda.empty_cache()
    emit({"attn_decode_b1_timing": rows})
    return rows


def run_format_paths(cfg, prompt, gen):
    """Path f at full width and F_LAYERS layers: f1, each of Q4_1, Q4_2,
    Q4_3, Q5_0, Q5_1 over the bf16 head-major cache (kernel A in every
    matmul); f2, GGML_TPU_INT_DOT=1 for Q8_0, Q4_0, Q4_1, Q5_0, Q5_1
    (kernel B in every decode matmul but the LM head's, whose activations
    stay f32; the prompt's 16 rows keep the dequant kernels). A prompt plus
    F_NEW tokens each, counters reset around each run, each run held
    against its plain path under its own settings (tol 0.1, as path a).
    Returns the summed launches and the compare errors."""
    import dataclasses

    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels.matmul_q import KERNEL_OF
    from ggmlsharp_tpu_torch.models import llama

    fcfg = dataclasses.replace(cfg, n_layer=F_LAYERS)
    L = F_LAYERS
    total, errs = {}, {}
    for route, formats in (("f1", A_FORMATS[:5]), ("f2", B_FORMATS)):
        for fmt in formats:
            params = llama.synthetic_params(fcfg, GType[fmt], seed=SEED)
            kern = KERNEL_OF[GType[fmt]]
            if route == "f1":
                want = {kern: (4 * L + 1) * (1 + F_NEW), "flash_attn": L}
            else:
                os.environ["GGML_TPU_INT_DOT"] = "1"
                want = {kern: 4 * L + 1 + F_NEW, "flash_attn": L,
                        "matmul_int_dot": 4 * L * F_NEW}
            try:
                toks, counts = run_fused_path(
                    fcfg, params, prompt, f"{route} {fmt}", F_NEW, want,
                    tag="llama_format_path")
                errs[f"{route} {fmt}"] = compare_plain(
                    llama, fcfg, params, prompt, quant_acts=True,
                    cache_dtype=torch.bfloat16, tol=0.1, toks=toks,
                    route=f"{route} {fmt}")
            finally:
                os.environ.pop("GGML_TPU_INT_DOT", None)
            for key, v in counts.items():
                total[key] = total.get(key, 0) + v
            del params
            torch.cuda.empty_cache()
    return total, errs


# --- the training slice: kernel 2 in full (both entries, softcap, f16,
# D <= 256, the gradient), path g (GPT-2 124M Adam steps), path h (the
# graph layer: Test3's L-BFGS fit and a flash-attention decoder), and GPT-2
# 124M INT8 serving over the head-major cache --------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 128, 4   # path g: bench.py's train shape
# path h's decoder: GPT-2 124M's widths and vocabulary, 2 layers
GRAPH_V, GRAPH_E, GRAPH_H, GRAPH_S, GRAPH_LAYERS, GRAPH_STEPS = \
    50257, 768, 12, 128, 2, 4
TEST3_NP, TEST3_NF = 4096, 256              # the reference's Test3
SERVE_G_SLOTS, SERVE_G_REQS, SERVE_G_PLEN, SERVE_G_NEW = 2, 4, 16, 16
# (label, entry, lead dims or (B, Hq, Hkv), Sq, Sk, D, causal, n_past, dtype,
#  softcap); the cached entry's npast is [n_past] * B
FLASH2_CASES = [
    ("unc_causal_f32_d64", "uncached", (4, 8), 40, 40, 64, True, 0, "f32", 0.0),
    ("unc_full_f32_d64_sq_ne_sk", "uncached", (2, 8), 24, 72, 64, False, 0,
     "f32", 0.0),
    ("unc_causal_npast16_bf16_d64", "uncached", (2, 8), 24, 40, 64, True, 16,
     "bf16", 0.0),
    ("unc_causal_d8_f32", "uncached", (12,), 128, 128, 8, True, 0, "f32", 0.0),
    ("unc_causal_d256_bf16", "uncached", (2, 4), 64, 64, 256, True, 0, "bf16",
     0.0),
    ("unc_full_d256_f16", "uncached", (2, 4), 33, 50, 256, False, 0, "f16",
     0.0),
    ("unc_causal_d64_f16_softcap30", "uncached", (2, 8), 48, 48, 64, True, 0,
     "f16", 30.0),
    ("cached_gqa_d256_f32_softcap30", "cached", (2, 8, 2), 20, 64, 256, True,
     9, "f32", 30.0),
    ("cached_d8_bf16", "cached", (1, 4, 4), 16, 32, 8, True, 3, "bf16", 0.0),
    ("cached_train_g_bf16", "cached", (TRAIN_B, 12, 12), TRAIN_S, TRAIN_S, 64,
     True, 0, "bf16", 0.0),
    ("cached_train_g_bf16_softcap30", "cached", (TRAIN_B, 12, 12), TRAIN_S,
     TRAIN_S, 64, True, 0, "bf16", 30.0),
]
_DT = {"f32": "float32", "bf16": "bfloat16", "f16": "float16"}


def flash2_inputs(dev, gen, entry, lead, sq, sk, D, n_past, dt):
    """q, k, v (and npast for the cached entry) of one FLASH2 case; k/v of
    the cached entry are T-row prefix views of a buffer 16 rows longer."""
    import torch

    dtype = getattr(torch, _DT[dt])
    if entry == "uncached":
        q = torch.randn((*lead, sq, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((*lead, sk, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        return q, k, v, None
    B, Hq, Hkv = lead
    q = torch.randn((B, Hq, sq, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, Hkv, sk + 16, D), generator=gen, device=dev)
            .to(dtype)[:, :, :sk] for _ in range(2))
    npast = torch.full((B,), n_past, dtype=torch.int32, device=dev)
    return q, k, v, npast


def check_flash_train(dev, gen):
    """Kernel 2's entries vs their plain versions (_uncached_ref,
    _cached_ref) on the same inputs, every FLASH2 case. Both compute in f32
    from the same (bf16, f16) input values: rtol 2e-4 / atol 2e-5 as for the
    cached entry (online vs dense softmax, f32 summation order), plus one
    output ulp where the uncached entry rounds to a 16-bit q dtype (up to
    2^-7 of |want| for bf16, 2^-10 for f16). Then, at path g's shape, the
    gradients dq, dk, dv of the cached entry's Function (its backward
    recomputes _cached_ref under autograd) against autograd of _cached_ref
    itself, and a double backward (an HVP) at a small shape: both sides
    run the same dense operations, so they must agree to the f32 bar (bf16
    gradients: one bf16 ulp, up to 2^-7 of |want|)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.flash import (
        _cached_ref, _uncached_ref, flash_attention, flash_attention_cached)

    rows, worst = [], {}
    for label, entry, lead, sq, sk, D, causal, n_past, dt, cap in FLASH2_CASES:
        q, k, v, npast = flash2_inputs(dev, gen, entry, lead, sq, sk, D,
                                       n_past, dt)
        sc = D ** -0.5
        if entry == "uncached":
            got = flash_attention(q, k, v, causal=causal, n_past=n_past,
                                  softcap=cap)
            want = _uncached_ref(q, k, v, causal, n_past, sc, cap).to(q.dtype)
            ulp = {"f32": 0.0, "bf16": 2 ** -7, "f16": 2 ** -10}[dt]
        else:
            got = flash_attention_cached(q, k, v, npast, softcap=cap)
            want = _cached_ref(q, k, v, npast, sc, cap)
            ulp = 0.0
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        ok = got.dtype == want.dtype and bool(torch.isfinite(got).all()) \
            and bool((err <= 2e-5 + (2e-4 + ulp) * want.abs()).all())
        worst[entry] = max(worst.get(entry, 0.0), float(err.max()))
        rows.append({"case": label, "entry": entry, "dtype": dt, "D": D,
                     "softcap": cap, "max_abs_err": float(err.max()),
                     "ok": ok})
        if not ok:
            emit({"flash2_check": rows})
            raise SystemExit(f"flash kernel disagrees in case {label}")

    def grads(fn, xs, g, create=False):
        out = fn(*xs)
        return torch.autograd.grad(out, xs, g, create_graph=create)

    grad_rows = []
    for label, (B, H, S, D, dt), hvp in (
            ("train_g_grad", (TRAIN_B, 12, TRAIN_S, 64, "bf16"), False),
            ("hvp_small_f32", (2, 4, 24, 32, "f32"), True)):
        dtype = getattr(torch, _DT[dt])
        xs = [torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
              .requires_grad_() for _ in range(3)]
        npast = torch.zeros((B,), dtype=torch.int32, device=dev)
        g = torch.randn((B, H, S, D), generator=gen, device=dev)
        kern = lambda a, b, c: flash_attention_cached(a, b, c, npast)
        plain = lambda a, b, c: _cached_ref(a, b, c, npast, D ** -0.5)
        gk = grads(kern, xs, g, hvp)
        gp = grads(plain, xs, g, hvp)
        if hvp:
            us = [torch.randn_like(x) for x in xs]
            gk = torch.autograd.grad(sum((a * u).sum()
                                         for a, u in zip(gk, us)), xs)
            gp = torch.autograd.grad(sum((a * u).sum()
                                         for a, u in zip(gp, us)), xs)
        torch.cuda.synchronize()
        ulp = 2 ** -7 if dt == "bf16" else 0.0
        for name, a, b in zip(("dq", "dk", "dv"), gk, gp):
            a, b = a.float(), b.float()
            err = (a - b).abs()
            ok = bool(torch.isfinite(a).all()) and bool(
                (err <= 2e-5 + (2e-4 + ulp) * b.abs()).all())
            grad_rows.append({"case": label, "grad": name,
                              "max_abs_err": float(err.max()),
                              "max_abs": float(b.abs().max()), "ok": ok})
            worst["grad"] = max(worst.get("grad", 0.0), float(err.max()))
            if not ok:
                emit({"flash2_check": rows, "flash2_grad_check": grad_rows})
                raise SystemExit(f"flash gradient disagrees: {label} {name}")
    emit({"flash2_check": rows, "flash2_grad_check": grad_rows})
    return worst


def train_step_flops(n_params, tokens):
    """bench.py's basis: 6 FLOPs a parameter a token (forward + backward)."""
    return 6.0 * n_params * tokens


def run_train_path(dev, smi, cfg):
    """Path g: GPT-2 124M at full width and depth, bf16 parameters from
    init_params (seed 0), one fixed batch of TRAIN_B x (TRAIN_S + 1) tokens
    from a seeded generator, bench.py's loss (models.common.lm_loss).

    First the loss and every leaf's gradient on the kernel route against the
    plain route (plain=True: _cached_ref in place of the kernel); bar: 5e-2
    relative L2 a leaf, 1e-3 relative on the loss. The routes differ in f32
    summation order inside attention, and bf16 rounds every op's output, so
    a one-ulp flip (up to 2^-8 relative) at one place starts a difference
    that each later bf16 rounding on the backward's path (12 layers x ~15
    ops) can grow by as much again: as a random walk, 2^-8 * sqrt(180) =
    0.05. Then TRAIN_STEPS Adam steps through
    optim.opt_fn (AdamParams' alpha 1e-3, stopping rules off), the launch
    counters reset just before and read just after: one flash launch a
    layer a step. The loss at the final parameters must be below the first;
    the median step time of steps 2-4 gives tokens/s and the share of the
    bf16 dense peak at 6 FLOPs a parameter a token; peak memory counts what
    the path allocates above what earlier paths keep resident. Last, a
    torch.profiler window of two more steps (device time, launches, idle
    share)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.models.common import lm_loss
    from ggmlsharp_tpu_torch.optim import OptParams, OptType, opt_fn, \
        value_and_grad
    from ggmlsharp_tpu_torch.optim.tree import tree_leaves

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = gpt2.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                              device=dev, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in tree_leaves(params))
    toks = torch.randint(0, cfg.n_vocab, (TRAIN_B, TRAIN_S + 1),
                         generator=torch.Generator(dev).manual_seed(SEED + 1),
                         device=dev, dtype=torch.int32)
    loss = lambda p: lm_loss(gpt2.forward, cfg, p, toks)
    loss_plain = lambda p: lm_loss(gpt2.forward, cfg, p, toks, plain=True)

    torch.cuda.synchronize()
    kernels.reset_launches()
    f_k, g_k = value_and_grad(loss)(params)
    torch.cuda.synchronize()
    vg_counts = dict(kernels.LAUNCHES)
    f_p, g_p = value_and_grad(loss_plain)(params)
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(tree_leaves(g_k), tree_leaves(g_p))]
    cmp = {"loss": float(f_k), "loss_plain": float(f_p),
           "loss_rel_err": abs(float(f_k) - float(f_p)) / abs(float(f_p)),
           "leaves": len(rel), "grad_rel_l2_max": max(rel),
           "grad_rel_l2_median": statistics.median(rel), "bar": 5e-2,
           "vg_launches": {k: v for k, v in vg_counts.items() if v}}
    emit({"train_plain_compare": cmp})
    if not (cmp["loss_rel_err"] <= 1e-3 and max(rel) <= 5e-2
            and all(v == v for v in rel)):
        raise SystemExit(f"path g: kernel route disagrees with plain: {cmp}")
    if vg_counts != dict.fromkeys(kernels.LAUNCHES, 0) | {
            "flash_attn": cfg.n_layer}:
        raise SystemExit(f"path g: a loss evaluation launched {vg_counts}")
    del g_k, g_p

    prm = OptParams(type=OptType.ADAM)
    prm.adam.n_iter = TRAIN_STEPS
    prm.adam.eps_f = 0.0
    prm.past = prm.max_no_improvement = 0
    stamps, losses = [], []

    def on_step(it, f):  # opt_adam has read f back: the step is done
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    x, fx, res, iters = opt_fn(loss, params, prm, on_step)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        f_end = float(loss(x))
    one = OptParams(type=OptType.ADAM)
    one.adam.n_iter = 1
    prof = profile_steps(lambda: opt_fn(loss, x, one), 2)
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    med = statistics.median(step_s[1:])
    tok_s = TRAIN_B * TRAIN_S / med
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn": cfg.n_layer * TRAIN_STEPS}
    out = {"config": f"GPT-2 E {cfg.n_embd} x {cfg.n_layer} layers, bf16",
           "card": smi, "n_params": n_params,
           "batch": TRAIN_B, "seq": TRAIN_S, "steps": iters,
           "result": res.name, "losses": losses, "loss_after": f_end,
           "step_s": step_s, "step_ms_median_2_4": med * 1e3,
           "tokens_per_s": tok_s,
           "model_flop_s": train_step_flops(n_params, TRAIN_B * TRAIN_S) / med,
           "bf16_peak_share": train_step_flops(n_params, tok_s) / BF16_FLOP_S,
           "peak_mem_gb": (peak - base) / 1e9, "launches": counts,
           "profile": prof,
           "device_idle_share": (1.0 - prof["device_ms_per_step"] / (med * 1e3)
                                 if isinstance(prof["device_ms_per_step"],
                                               float) else "not measured"),
           "expected_launches": want,
           "flash_launches_per_step": counts["flash_attn"] / TRAIN_STEPS}
    emit({"train_path": out})
    if counts != want:
        raise SystemExit(f"path g launch counts {counts} != {want}")
    if iters != TRAIN_STEPS or not f_end < losses[0] or f_end != f_end:
        raise SystemExit(f"path g: the loss did not fall: {out}")
    return out, counts


def test3_data(np_, nf):
    """The reference's Test3 data: MSVC-LCG noise over a block-indicator
    design (tests/test_optim.py::_test3_data), made on the host."""
    import numpy as np

    state = 0
    F = np.zeros((np_, nf), np.float32)
    lab = np.where(np.arange(np_) < np_ // 2, 1.0, -1.0).astype(np.float32)
    for j in range(np_):
        row = F[j]
        for i in range(nf):
            state = (214013 * state + 2531011) & 0xFFFFFFFF
            ind = 1.0 if (lab[j] > 0) == (i < nf // 2) else 0.0
            row[i] = (ind + (((state >> 16) & 0x7FFF) / 32767.0 - 0.5)
                      * 0.1) / (0.5 * nf)
    return F, lab


def graph_decoder(B, leaf, weights, S, H, plain):
    """The decoder of examples/graph_transformer.py through the graph API,
    B.flash_attn in place of its mul_mat / diag_mask_inf / soft_max chain
    (plain=True: the op's materialised-scores route). weights: wte [V, E],
    then per layer wq, wk, wv, wo [E, E], w_up [4E, E], w_down [E, 4E], each
    a tensor on the card. Returns (tokens leaf, logits node, params)."""
    import torch

    from ggmlsharp_tpu_torch.graph import set_param

    ws = [set_param(leaf(w)) for w in weights]
    it = iter(ws)
    wte = next(it)
    E = weights[0].shape[1]
    hd = E // H
    tok = leaf(torch.zeros((S,), dtype=torch.int32, device=weights[0].device))
    x = B.get_rows(wte, tok)
    for _ in range((len(weights) - 1) // 6):
        wq, wk, wv, wo, w_up, w_down = (next(it) for _ in range(6))
        h = B.rms_norm(x)
        q, k, v = (B.permute(B.reshape(B.mul_mat(w, h), (S, H, hd)),
                             (1, 0, 2)) for w in (wq, wk, wv))
        o = B.flash_attn(B.rope(q, 0), B.rope(k, 0), v, plain=plain)
        o = B.reshape(B.cont(B.permute(o, (1, 0, 2))), (S, E))
        x = B.add(x, B.mul_mat(wo, o))
        x = B.add(x, B.mul_mat(w_down, B.gelu(B.mul_mat(w_up, B.rms_norm(x)))))
    return tok, B.mul_mat(wte, B.rms_norm(x)), ws


def run_graph_test3(dev, smi):
    """Path h1, Test3, the reference's largest workload: the 4096 x 256
    L2-regularised linear classifier through the ggml_* API (a context on
    the card) and ggml_opt with L-BFGS; every weight within 1e-2 of +-1."""
    import torch

    from ggmlsharp_tpu_torch import GType, compat
    from ggmlsharp_tpu_torch.graph import builders as B, set_data

    F, lab = test3_data(TEST3_NP, TEST3_NF)
    ctx = compat.ggml_init()
    Fl = set_data(compat.ggml_new_tensor_2d(ctx, GType.F32, TEST3_NF,
                                            TEST3_NP), F)
    ll = set_data(compat.ggml_new_tensor_1d(ctx, GType.F32, TEST3_NP), lab)
    w = compat.ggml_new_tensor_1d(ctx, GType.F32, TEST3_NF)
    compat.ggml_set_param(ctx, w)
    err = compat.ggml_sub(ctx, compat.ggml_mul_mat(ctx, Fl, w), ll)
    f = compat.ggml_add(
        ctx, B.scale_const(compat.ggml_sum(ctx, compat.ggml_sqr(ctx, err)),
                           1.0 / TEST3_NP),
        B.scale_const(compat.ggml_sum(ctx, compat.ggml_sqr(ctx, w)), 1e-5))
    prm = compat.ggml_opt_default_params(compat.GGML_OPT_LBFGS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = compat.ggml_opt(ctx, prm, f)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    w_true = torch.where(torch.arange(TEST3_NF, device=dev) < TEST3_NF // 2,
                         1.0, -1.0)
    w_err = float((w.data - w_true).abs().max())
    h1 = {"workload": "Test3 4096 x 256 L-BFGS via ggml_opt", "card": smi,
          "result": res.name, "max_abs_weight_err": w_err, "bar": 1e-2,
          "seconds": secs, "device": str(w.data.device)}
    emit({"graph_test3": h1})
    if w_err > 1e-2 or res.name not in ("OK", "DID_NOT_CONVERGE") \
            or w.data.device.type != dev.type:
        raise SystemExit(f"path h1: Test3 missed its criterion: {h1}")
    return h1


def run_graph_decoder(dev, gen, smi):
    """Path h2: a decoder built as examples/graph_transformer.py builds it, with
    flash_attn in place of its attention chain, at E 768, 12 heads of D 64,
    S 128, 2 layers, V 50257, f32 weights N(0, 0.02) from the generator. The
    objective -mean over positions of soft_max(logits) at the target token.
    build_forward and build_backward, computed once on the kernel route and
    once on the plain route (the same graph built with plain=True), held to
    1e-4 relative on the loss and 1e-3 relative L2 a weight's gradient (f32
    throughout; the routes differ in summation order, and the generic VJPs
    add the dense backward's own). Then GRAPH_STEPS Adam steps of opt()
    (stopping rules off), the counters reset just before: the uncached
    entry launches once a layer a forward, and the backward graph's generic
    VJPs of each flash_attn node rerun its forward once a source (3 a
    layer)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.graph import (build_backward, build_forward,
                                           builders as B, leaf, set_data,
                                           set_f32)
    from ggmlsharp_tpu_torch.optim import OptParams, OptType, opt

    V, E, H, S = GRAPH_V, GRAPH_E, GRAPH_H, GRAPH_S
    shapes = [(V, E)] + ([(E, E)] * 4 + [(4 * E, E), (E, 4 * E)]) \
        * GRAPH_LAYERS
    weights = [torch.randn(s, generator=gen, device=dev) * 0.02
               for s in shapes]
    toks = torch.randint(0, V, (S,), generator=gen, device=dev,
                         dtype=torch.int32)
    onehot = torch.zeros((S, V), device=dev)
    onehot[torch.arange(S, device=dev),
           torch.randint(0, V, (S,), generator=gen, device=dev)] = 1.0
    runs = {}
    for plain in (False, True):
        tok, logits, ws = graph_decoder(B, leaf, weights, S, H, plain)
        set_data(tok, toks)
        obj = B.scale_const(B.sum(B.mul(B.soft_max(logits), leaf(onehot))),
                            -1.0 / S)
        gf = build_forward(obj)
        gb = build_backward(gf)
        gf.reset()
        set_f32(obj.grad, 1.0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        gb.compute()
        torch.cuda.synchronize()
        runs[plain] = {"obj": obj, "ws": ws, "f": float(obj.data[0]),
                       "grads": [x.grad.data.clone() for x in ws],
                       "launches": dict(kernels.LAUNCHES),
                       "seconds": time.perf_counter() - t0,
                       "n_nodes": len(gb.nodes)}
    k, p = runs[False], runs[True]
    rel = [float((a - b).norm() / b.norm()) for a, b in
           zip(k["grads"], p["grads"])]
    want_bwd = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn_uncached": 4 * GRAPH_LAYERS}
    cmp = {"loss": k["f"], "loss_plain": p["f"],
           "loss_rel_err": abs(k["f"] - p["f"]) / abs(p["f"]),
           "grad_rel_l2_max": max(rel), "n_nodes": k["n_nodes"],
           "backward_graph_seconds": k["seconds"],
           "launches": k["launches"], "expected_launches": want_bwd,
           "plain_launches": {n: c for n, c in p["launches"].items() if c}}
    emit({"graph_decoder_compare": cmp})
    if cmp["loss_rel_err"] > 1e-4 or max(rel) > 1e-3 \
            or k["launches"] != want_bwd or any(p["launches"].values()):
        raise SystemExit(f"path h2: the graph disagrees or launched wrong: "
                         f"{cmp}")
    prm = OptParams(type=OptType.ADAM)
    prm.adam.n_iter = GRAPH_STEPS
    prm.adam.eps_f = 0.0
    prm.past = prm.max_no_improvement = 0
    losses = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res2, fx = opt(k["obj"], prm, lambda it, fv: losses.append(fv))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    gf = build_forward(k["obj"])
    gf.compute()
    f_end = float(k["obj"].data[0])
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn_uncached": GRAPH_LAYERS * GRAPH_STEPS}
    h2 = {"decoder": f"E {E}, {H} heads, S {S}, {GRAPH_LAYERS} layers, V {V}",
          "card": smi, "steps": GRAPH_STEPS, "losses": losses,
          "loss_after": f_end, "seconds": secs, "launches": counts,
          "expected_launches": want}
    emit({"graph_decoder_train": h2})
    if counts != want or not f_end < losses[0]:
        raise SystemExit(f"path h2: opt() failed: {h2}")
    total = {n: k["launches"][n] + counts[n] for n in counts}
    return cmp, h2, total


def run_gpt2_int8_serving(gcfg, gparams):
    """GPT-2 124M (path c's Q8_0 weights) behind serving.Engine with an INT8
    cache, which for GPT-2 is head-major: SERVE_G_SLOTS slots, SERVE_G_REQS
    requests of SERVE_G_PLEN + SERVE_G_NEW tokens, the counters reset just
    before; then the same engine with plain=True. Weight-only
    (GGML_TPU_QUANT_ACTS=0), so the two differ in f32 summation order alone
    (the INT8 rows round the same values); each request's tokens must be the
    plain engine's."""
    import functools

    import numpy as np
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.serving import Engine, Request

    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, gcfg.n_vocab, size=SERVE_G_PLEN).tolist()
               for _ in range(SERVE_G_REQS)]
    outs, counts, layout = {}, None, None
    os.environ["GGML_TPU_QUANT_ACTS"] = "0"
    try:
        for plain in (False, True):
            fwd = functools.partial(gpt2.forward, plain=True) if plain \
                else gpt2.forward
            eng = Engine(fwd, gcfg, gparams, batch_slots=SERVE_G_SLOTS,
                         max_len=SERVE_MAX_LEN, int8_kv=True)
            layout = (eng.cache.int8, eng.cache.is_flat,
                      tuple(eng.cache.k[0].shape))
            for i, p in enumerate(prompts):
                eng.submit(Request(id=i, prompt=p,
                                   max_new_tokens=SERVE_G_NEW))
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = {r.id: r for r in eng.run()}
            torch.cuda.synchronize()
            if not plain:
                counts = dict(kernels.LAUNCHES)
                secs = time.perf_counter() - t0
                st = eng.stats()
            outs[plain] = res
            del eng
    finally:
        os.environ.pop("GGML_TPU_QUANT_ACTS")
    same = [outs[False][i].out_tokens == outs[True][i].out_tokens
            for i in range(SERVE_G_REQS)]
    out = {"model": "GPT2_124M Q8_0", "slots": SERVE_G_SLOTS,
           "requests": SERVE_G_REQS, "cache_int8_flat_shape": layout,
           "seconds": secs, "tokens_per_s": SERVE_G_REQS * SERVE_G_NEW / secs,
           "ticks": st["ticks"], "launches": counts,
           "tokens_equal_plain": same,
           "first_tokens": [outs[False][i].out_tokens[:4] for i in range(2)]}
    emit({"gpt2_int8_serving": out})
    bad = [i for i in range(SERVE_G_REQS)
           if outs[False][i].error or len(outs[False][i].out_tokens)
           != SERVE_G_NEW]
    if not (layout[0] and not layout[1]) or bad or not all(same) \
            or counts["flash_attn"] == 0 or counts["attn_decode"] != 0:
        raise SystemExit(f"GPT-2 INT8 serving failed: {out}")
    return out, counts


def flash2_bound_ms(B, Hq, Hkv, S, T, D, in_bytes, out_bytes, npast=0,
                    causal=True):
    """Bytes of q (in_bytes an element), out (out_bytes) and the K/V rows the
    queries keep, once each; 4 * D operations a kept (query, key) pair at
    the bf16 tensor-core rate (16-bit inputs) or the f32 rate."""
    kept = min(T, S + npast) if causal else T
    bytes_ = B * Hq * S * D * (in_bytes + out_bytes) \
        + 2 * B * Hkv * kept * D * in_bytes
    pairs = sum(min(T, s + npast + 1) for s in range(S)) if causal else S * T
    flops = 4 * B * Hq * pairs * D
    rate = BF16_FLOP_S if in_bytes == 2 else F32_FLOP_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_flash_train(dev, gen):
    """Path g's attention call (B 8, H 12, S = T 128, D 64, bf16 q/k/v,
    causal, npast 0): the uncached entry, the cached entry with softcap 30
    and without, the plain version (_cached_ref and _uncached_ref), SDPA
    (is_causal) forward; then the Function's backward (its dense recompute)
    against SDPA's backward, each as forward + backward less the forward.
    CUDA-graph replay, cold L2: the calls cycle through enough input copies
    to exceed it four times."""
    import torch

    from ggmlsharp_tpu_torch.kernels.flash import (
        _cached_ref, _uncached_ref, flash_attention, flash_attention_cached)

    B, H, S, D = TRAIN_B, 12, TRAIN_S, 64
    copies = max(2, -(-4 * L2_BYTES // (3 * B * H * S * D * 2)))
    xs = [[torch.randn((B, H, S, D), generator=gen, device=dev)
           .to(torch.bfloat16).requires_grad_() for _ in range(3)]
          for _ in range(copies)]
    npast = torch.zeros((B,), dtype=torch.int32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    reps = max(100, copies)
    with torch.no_grad():
        res = {
            "cold_copies": copies,
            "uncached_ms": time_ms(lambda i: flash_attention(
                *xs[i % copies]), reps),
            "cached_ms": time_ms(lambda i: flash_attention_cached(
                *xs[i % copies], npast), reps),
            "cached_softcap_ms": time_ms(lambda i: flash_attention_cached(
                *xs[i % copies], npast, softcap=30.0), reps),
            "plain_ms": time_ms(lambda i: _cached_ref(
                *xs[i % copies], npast, D ** -0.5), reps),
            "uncached_plain_ms": time_ms(lambda i: _uncached_ref(
                *xs[i % copies], True, 0, D ** -0.5).to(torch.bfloat16), reps),
            "sdpa_ms": time_ms(lambda i: sdpa(*xs[i % copies], is_causal=True),
                               reps),
        }
    g = torch.randn((B, H, S, D), generator=gen, device=dev)
    gs = g.to(torch.bfloat16)
    # forward and backward captured together (a backward replays on its
    # forward's stream); the backward alone is the difference
    res["fwd_bwd_ms"] = time_ms(lambda i: torch.autograd.grad(
        flash_attention_cached(*xs[i % copies], npast), xs[i % copies], g),
        copies)
    res["sdpa_fwd_bwd_ms"] = time_ms(lambda i: torch.autograd.grad(
        sdpa(*xs[i % copies], is_causal=True), xs[i % copies], gs), copies)
    res["bwd_ms"] = res["fwd_bwd_ms"] - res["cached_ms"]
    res["sdpa_bwd_ms"] = res["sdpa_fwd_bwd_ms"] - res["sdpa_ms"]
    res["uncached_bound_ms"], res["bound_by"] = flash2_bound_ms(
        B, H, H, S, S, D, 2, 2)
    res["cached_bound_ms"], _ = flash2_bound_ms(B, H, H, S, S, D, 2, 4)
    emit({"flash_train_timing": res})
    return res


# --- the tuning slice: the TPU probes' counterparts (sites 12-17, the last
# pallas_call sites of the repo, in scripts/), the launch geometry of the
# three dequant-matmul sources and the tune table that dispatch reads, and
# path i (LLAMA_13B Q4_0 decode through the tuned dispatch) ------------------
I_NEW = 8  # path i: greedy tokens after the 16-token prompt
GEOM_SHAPES = [("7b_wo", 4096, 4096), ("ragged", 4099, 11008)]
GEOM_B = (1, 5)


def check_geometries(dev, gen):
    """Every compiled launch geometry of the three dequant-matmul sources
    gives the default's bits, at a 7B shape and at a ragged one (N a
    multiple of no block's rows, K = 11008), b 1 and 5 (ragged b), for each
    format the source decodes."""
    import torch

    from ggmlsharp_tpu_torch.kernels import tune
    from ggmlsharp_tpu_torch.kernels.matmul_q import (q4_0_matmul,
                                                      q8_0_matmul, q_matmul)

    calls = {"Q4_0": lambda x, w, g: q4_0_matmul(x, w["qs"], w["d"], g),
             "Q8_0": lambda x, w, g: q8_0_matmul(x, w["qs"], w["d"], g)}
    calls.update({f: (lambda x, w, g: q_matmul(x, w, g)) for f in A_FORMATS})
    rows = []
    for fmt, fn in calls.items():
        for label, n, k in GEOM_SHAPES:
            w = random_weight(fmt, n, k, gen, dev)
            for b in GEOM_B:
                x = torch.randn((b, k), generator=gen, device=dev)
                ref = fn(x, w, tune.DEFAULT)
                same = {f"{g[0]}x{g[1]}": bool(torch.equal(fn(x, w, g), ref))
                        for g in tune.GEOMETRIES}
                rows.append({"format": fmt, "shape": label, "n": n, "k": k,
                             "b": b, "bit_equal_default": same,
                             "finite": bool(torch.isfinite(ref).all())})
                if not (all(same.values()) and rows[-1]["finite"]):
                    emit({"geometry_check": rows})
                    raise SystemExit(f"a launch geometry changes the bits: "
                                     f"{rows[-1]}")
    emit({"geometry_check": {"cases": len(rows), "geometries":
                             [list(g) for g in tune.GEOMETRIES],
                             "all_bit_equal": True}})
    return len(rows)


def run_probe_path(dev):
    """The TPU probes' counterparts through their entry points' run(): the
    three Q4_UNPACK builds (i2f bit-equal to prmt, half2 within its bar),
    the copy ceiling at 8 MB and 1 GiB, the byte map, the K-major matvec
    (checked and timed), the f16 decode, the block maps and the bad-entry
    map; counters reset just before, read just after."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.probes import dq_variants, scale_decode, swar

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = {"dq": dq_variants.run(dev), "swar": swar.run(dev),
           "scale": scale_decode.run(dev)}
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    ran = ("matmul_q4_0", "matmul_q4_0_i2f", "matmul_q4_0_half2",
           "probe_copy", "probe_byte_order", "matmul_q4_0_kmajor",
           "probe_f16_decode", "probe_block_map")
    emit({"tuning_probes": {"seconds": res["seconds"], "launches": counts}})
    if not all(counts[k] for k in ran):
        raise SystemExit(f"a probe kernel never launched: {counts}")
    return res, counts


def tune_rows(res):
    """The kernels-line rows of sites 12-17 from the probe path's results."""
    from ggmlsharp_tpu_torch.probes.dq_variants import VARIANTS

    site = next(r for r in res["dq"]["timing"]
                if (r["n"], r["k"]) == (4096, 4096))
    chk = res["dq"]["check"]
    unit = ("one call at the site's shape, N = K = 4096, b = 1, cold L2; "
            "plain = ops.mul_mat_q, library = bf16 torch.matmul over the "
            "dequantized weight")
    rows = []
    for var in ("i2f", "half2"):
        rows.append({
            "name": f"matmul_q4_0_{var}", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/matmul_q4_0.cu "
                      f"(-DQ4_UNPACK={VARIANTS[var]})",
            "replaces": "scripts/probe_dq_variants.py:81",
            "ms": site[f"{var}_ms"], "plain_ms": site["plain_ms"],
            "bound_ms": site["bound_ms"], "bound_by": site["bound_by"],
            "library_ms": site["library_ms"],
            "max_abs_err": max(c["max_abs_err"][var] for c in chk),
            "prmt_ms": site["prmt_ms"], "unit": unit,
            "by_shape_ms": {f"{r['n']}x{r['k']}": r[f"{var}_ms"]
                            for r in res["dq"]["timing"]},
            "prmt_by_shape_ms": {f"{r['n']}x{r['k']}": r["prmt_ms"]
                                 for r in res["dq"]["timing"]},
            **({"i2f_bit_equal_prmt": all(c["i2f_equals_prmt"]
                                          for c in chk)} if var == "i2f"
               else {"half2_err_over_bar": max(c["half2_err_over_bar"]
                                               for c in chk),
                     "half2_terms_t": chk[0]["half2_terms_t"]})})
    c8, c1g = res["dq"]["copy"]
    rows.append({
        "name": "probe_copy", "route": "cuda",
        "source": "ggmlsharp_tpu_torch/csrc/probes.cu",
        "replaces": "scripts/probe_dq_variants.py:105",
        "ms": c8["ms"], "plain_ms": c8["plain_ms"], "bound_ms": c8["bound_ms"],
        "bound_by": c8["bound_by"], "library_ms": c8["library_ms"],
        "max_abs_err": 0.0, "gb_s": c8["gb_s"], "ms_1gib": c1g["ms"],
        "gb_s_1gib": c1g["gb_s"], "library_ms_1gib": c1g["library_ms"],
        "library_gb_s_1gib": c1g["library_gb_s"],
        "plain_ms_1gib": c1g["plain_ms"], "bound_ms_1gib": c1g["bound_ms"],
        "unit": "one copy of the site's 8 MB u32 plane (copies rotated past "
                "the L2); _1gib: of a 1 GiB plane; library = dst.copy_(src), "
                "plain = src.clone(); GB/s = read + write bytes"})
    bo = res["swar"]["byte_order"]
    rows.append({
        "name": "probe_byte_order", "route": "cuda",
        "source": "ggmlsharp_tpu_torch/csrc/probes.cu",
        "replaces": "scripts/probe_swar.py:61",
        "ms": bo["ms"], "plain_ms": bo["plain_ms"], "bound_ms": bo["bound_ms"],
        "bound_by": bo["bound_by"], "library_ms": None,
        "max_abs_err": bo["max_abs_err"], "order": bo["order"],
        "unit": "one call over 64 words; no library call maps load order"})
    km = next(r for r in res["swar"]["timing"]
              if (r["n"], r["k"]) == (4096, 4096))
    rows.append({
        "name": "matmul_q4_0_kmajor", "route": "cuda",
        "source": "ggmlsharp_tpu_torch/csrc/matmul_q4_0_kmajor.cu",
        "replaces": "scripts/probe_swar.py:105",
        "ms": km["kmajor_ms"], "plain_ms": km["plain_ms"],
        "bound_ms": km["bound_ms"], "bound_by": km["bound_by"],
        "library_ms": km["library_ms"],
        "max_abs_err": max(c["max_abs_err"] for c in res["swar"]["check"]),
        "row_default_ms": km["row_default_ms"],
        "row_tuned_ms": km["row_tuned_ms"],
        "by_shape": {f"{r['n']}x{r['k']}": {
            k: r[k] for k in ("kmajor_ms", "row_default_ms", "row_tuned_ms",
                              "tuned_geometry")}
            for r in res["swar"]["timing"]},
        "unit": "one call at N = K = 4096, b = 1, cold L2; row_* = "
                "matmul_q4_0 over the same weights in the row layout; "
                "library = bf16 torch.matmul over the dequantized weight"})
    for key, name, line, unit in (
            ("decode_timing", "probe_f16_decode", 42,
             "one call over all 65,536 f16 patterns; plain = library = "
             "d.float()"),
            ("block_map_timing", "probe_block_map", 68,
             "one Q4_0 row map at K = 11008; plain = library = "
             "repeat_interleave")):
        t = res["scale"][key]
        rows.append({"name": name, "route": "cuda",
                     "source": "ggmlsharp_tpu_torch/csrc/probes.cu",
                     "replaces": f"scripts/diag_chunked10.py:{line}",
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "max_abs_err": 0.0,
                     "unit": unit})
    return rows


def check_tune_table(dev, gen, smi):
    """The packaged tune table: its card against this one (a different card
    is an error line), each entry legal, and each entry timed against the
    default geometry at its shape, cold L2, three rounds in turns: at
    b = 1, where dispatch reads the table, and at b = 8 (the other
    instance of each source), where dispatch launches the default. Then
    the host time of one dispatch lookup (matmul_q.geometry)."""
    import statistics

    import torch

    from ggmlsharp_tpu_torch.kernels import autotune, matmul_q, tune

    table = tune.table()
    name = smi.split(",")[0].strip()
    tcard = table.get("_card", "")
    if tcard.split(",")[0].strip() != name:
        emit({"error": f"tune table measured on {tcard!r}; this card is "
                       f"{smi!r}"})
    kinds = {key: (kern, g) for key, kern, g, _, _ in autotune.targets()}
    rows, t0 = [], time.perf_counter()
    for key, ent in sorted(table.items()):
        if key.startswith("_"):
            continue
        geom = tune.legal(ent)
        if geom is None or key not in kinds:
            raise SystemExit(f"tune table entry {key}: {ent} is not legal")
        kern, g = kinds[key]
        n, k = (int(v) for v in key.split(":")[1].split("x"))
        ws = autotune.random_copies(g, n, k, gen, dev)
        fn = autotune.launcher(kern)
        reps = int(min(200, max(20, 1e-3 * 2.5e12 / ws[0].nbytes())))
        row = {"key": key, "geometry": list(geom)}
        for b in (1, 8):
            x = torch.randn((b, k), generator=gen, device=dev)
            s = {"default": [], "table": []}
            for _ in range(3):
                for lab, gg in (("default", tune.DEFAULT), ("table", geom)):
                    s[lab].append(time_ms(
                        lambda i: fn(x, ws[i % len(ws)], gg), reps))
            dm, tm = statistics.median(s["default"]), \
                statistics.median(s["table"])
            row[f"b{b}"] = {"default_ms": dm, "table_ms": tm,
                            "gain": dm / tm}
        rows.append(row)
        del ws
    _, kern0, g0, n0, k0 = autotune.targets()[0]
    matmul_q.geometry(kern0, n0, k0, g0)
    calls, h0 = 100_000, time.perf_counter()
    for _ in range(calls):
        matmul_q.geometry(kern0, n0, k0, g0)
    lookup_us = (time.perf_counter() - h0) * 1e6 / calls
    gains = {b: [r[b]["gain"] for r in rows] or [1.0] for b in ("b1", "b8")}
    out = {"card": tcard, "entries": len(rows), "rows": rows,
           "gain_b1_median": statistics.median(gains["b1"]),
           "gain_b8_median": statistics.median(gains["b8"]),
           "entries_slower_at_b8": sum(v < 1 for v in gains["b8"]),
           "lookup_us_per_launch": lookup_us,
           "seconds": time.perf_counter() - t0}
    emit({"tune_check": out})
    return out


def q4_0_weight_bytes(cfg):
    """Q4_0 bytes of the matmul weights a decode token reads once, counted
    from the config: four per block and the LM head (18 bytes a 32)."""
    E, F = cfg.n_embd, cfg.n_ff
    nq, nkv = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
    per_block = (nq + 2 * nkv) * E + E * nq + 2 * F * E + E * F
    vpad = -(-cfg.n_vocab // 256) * 256
    return (cfg.n_layer * per_block + vpad * E) * 18 // 32


def run_13b_path(dev, gen, smi):
    """Path i: LLAMA_13B (full width and depth) Q4_0 at b = 1, random N(0,
    1/k) weights quantized on the card one tensor at a time, a bf16
    head-major cache of n_ctx rows: a 16-token prompt and I_NEW greedy
    tokens, counters reset just before; every matmul through matmul_q4_0
    at the tune table's geometry for its shape (else the default), flash
    for the prompt; held against the plain route; then tok/s and the share
    of the HBM roofline."""
    import torch

    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.kernels import _build, tune
    from ggmlsharp_tpu_torch.kernels.matmul_q import geometry
    from ggmlsharp_tpu_torch.models import llama

    cfg = llama.LLAMA_13B
    t0 = time.perf_counter()
    params = llama.synthetic_params(cfg, GType.Q4_0, seed=SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.n_vocab, (1, PROMPT_LEN), generator=gen,
                           device=dev, dtype=torch.int32)
    L = cfg.n_layer
    toks, counts = run_fused_path(
        cfg, params, prompt, "i LLAMA_13B Q4_0, head-major bf16 cache",
        I_NEW, {"matmul_q4_0": (4 * L + 1) * (1 + I_NEW), "flash_attn": L},
        tag="llama_13b_path")
    geo = {k: v for k, v in _build.GEOMETRY_LAUNCHES.items()}
    shapes = {}
    for (kern, n, k, w, r, b), c in geo.items():
        want = geometry(kern, n, k, GType.Q4_0, b)
        shapes[f"{n}x{k} b{b}"] = {
            "geometry": [w, r], "launches": c,
            "from_table": b == 1
            and tune.lookup(kern, n, k, GType.Q4_0) is not None}
        if kern != "matmul_q4_0" or (w, r) != want:
            raise SystemExit(f"path i launched {kern} {n}x{k} b {b} at "
                             f"{(w, r)}; dispatch gives {want}")
    errs = [compare_plain(llama, cfg, params, prompt, quant_acts=True,
                          cache_dtype=torch.bfloat16, tol=0.1, toks=toks,
                          route="i LLAMA_13B Q4_0"),
            compare_plain(llama, cfg, params, prompt, quant_acts=False,
                          cache_dtype=torch.float32, tol=1e-3,
                          route="i LLAMA_13B Q4_0, f32 cache")]
    wbytes = q4_0_weight_bytes(cfg)
    dec = measure_decode(llama, cfg, params, prompt, wbytes,
                         cfg.n_head_kv * cfg.head_dim, n_warm=4, n_lat=16,
                         n_win=16, n_prof=4)
    dec.update(config="LLAMA_13B Q4_0", card=smi, load_s=load_s,
               geometry_by_shape=shapes, vs_plain_max_abs_err=errs)
    emit({"llama_13b_decode": dec})
    del params
    torch.cuda.empty_cache()
    return dec, counts


def profile_steps(one_step, n_steps):
    """torch.profiler over n_steps decode steps: device kernel time, kernel
    launches and aten calls a step, and the kernels that take the most
    device time. Device numbers read "not measured" if the trace holds no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    n_aten = sum(1 for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name.startswith("aten::"))
    dev_us = sum(e.device_time for e in kern)
    by_name: dict = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"traced_steps": n_steps,
            "traced_step_ms": wall * 1e3 / n_steps,
            "device_ms_per_step": dev_us / 1e3 / n_steps if dev_us
            else "not measured",
            "kernels_per_step": len(kern) / n_steps,
            "aten_calls_per_step": n_aten / n_steps,
            "top_kernels": [{"name": name[:80],
                             "ms_per_step": t / 1e3 / n_steps,
                             "calls_per_step": n / n_steps}
                            for name, (t, n) in top]}


def measure_decode(model, cfg, params, prompt, weight_bytes, kv_width,
                   kv_row_bytes=None, n_warm=8, n_lat=64, n_win=64, n_prof=8,
                   **cache_kw):
    """Prefill time, then per-token decode latency at b = 1 (host clock,
    synchronised each step; n_lat steps after n_warm), an n_win-token
    window without per-step sync, and a traced n_prof-step window
    (profile_steps). ``model``: models.llama or models.gpt2; weight_bytes:
    the matmul weights a token reads once; kv_width: elements of one cached
    K (or V) row; kv_row_bytes: its bytes (default bf16: 2 * kv_width);
    cache_kw goes to new_cache."""
    import torch

    from ggmlsharp_tpu_torch.models import sampling

    prefill, step = sampling.make_decode_fns(model.forward, cfg)
    T = cfg.n_ctx
    res = {}
    with torch.inference_mode():
        pre = []
        for _ in range(3):
            cache = model.new_cache(cfg, 1, **cache_kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompt, cache,
                                    t_eff=sampling.length_bucket(PROMPT_LEN, T))
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        res["prefill_ms"] = [p * 1e3 for p in pre]
        state = {"logits": logits, "cache": cache, "cur": PROMPT_LEN}

        def one_step():
            tok = torch.argmax(state["logits"], dim=-1,
                               keepdim=True).to(torch.int32)
            state["cur"] += 1
            state["logits"], state["cache"] = step(
                params, tok, state["cache"],
                t_eff=sampling.length_bucket(state["cur"], T))

        lat = []
        for i in range(n_warm + n_lat):
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            if i >= n_warm:
                lat.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_win):
            one_step()
        torch.cuda.synchronize()
        win = time.perf_counter() - t0
        cur = state["cur"]
        res["profile"] = profile_steps(one_step, n_prof)
    lat_ms = sorted(x * 1e3 for x in lat)
    res["step_ms_median"] = statistics.median(lat_ms)
    res["step_ms_p84"] = lat_ms[int(0.84 * len(lat_ms))]
    res["step_samples"] = len(lat_ms)
    res["window_tok_s"] = n_win / win
    dev_ms = res["profile"]["device_ms_per_step"]
    # idle share of an untraced step: the trace's device time a step over
    # the untraced median step (tracing slows the host, not the kernels)
    res["device_idle_share"] = (1.0 - dev_ms / res["step_ms_median"]
                                if isinstance(dev_ms, float)
                                else "not measured")
    # bytes a token must move: every matmul weight once plus the live K/V
    live = cur - n_win // 2
    kv_bytes = 2 * cfg.n_layer * live * (kv_row_bytes or 2 * kv_width)
    res["weight_bytes"] = weight_bytes
    res["bytes_per_token"] = weight_bytes + kv_bytes
    res["roofline_tok_s"] = HBM_BYTES_S / (weight_bytes + kv_bytes)
    res["roofline_share"] = res["window_tok_s"] / res["roofline_tok_s"]
    return res


def gpt2_weight_bytes(params):
    """Q8_0 bytes a GPT-2 decode token reads once: four weights a block and
    wte (the LM head)."""
    return params["wte"].nbytes() + sum(
        blk[grp][key].nbytes() for blk in params["blocks"]
        for grp, key in (("attn", "c_attn_w"), ("attn", "c_proj_w"),
                         ("mlp", "c_fc_w"), ("mlp", "c_proj_w")))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "ggmlsharp_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, repo)
    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.models import gpt2, llama

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1/6] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from ggmlsharp_tpu_torch.kernels.config import kernels_setting
    from ggmlsharp_tpu_torch.probes.dq_variants import variant_defines

    if kernels_setting() is not None:
        raise SystemExit(f"kernels_enabled() must be auto on every path, is "
                         f"forced to {kernels_setting()}")
    t0 = time.perf_counter()
    # every source, and the probe builds of matmul_q4_0.cu, in parallel
    logs = kernels.build(variants=[("matmul_q4_0", variant_defines(v))
                                   for v in ("i2f", "half2")])
    log(f"[2/6] built {sorted(logs) or 'nothing new'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(dev).manual_seed(SEED)
    q4_err = check_q4_0(dev, gen)
    q4_rows_ok = q4_rows_independent_of_b(dev, gen)
    rms_rows = rms_rows_independent_of_b(dev, gen)
    fl_err = check_flash(dev, gen)
    fl2_err = check_flash_train(dev, gen)
    ad_err = check_attn_decode(dev, gen)
    q8_err = check_q8_0(dev, gen)
    mlp_err = check_mlp_fused(dev, gen)
    layer_err = check_gpt2_layer(dev, gen)
    silu_err = check_mlp_fused_silu(dev, gen)
    llayer_err = check_llama_layer(dev, gen)
    attn_lay_err = check_attn_layout(dev, gen)
    mq_errs = check_matmul_q(dev, gen)
    ib_errs = check_int_dot(dev, gen)
    q_card = quantizers_on_card(dev, gen)
    geom_cases = check_geometries(dev, gen)
    if not q4_rows_ok:
        raise SystemExit("a Q4_0 row's result depends on b")
    log(f"[3/6] kernels agree with their plain versions: Q4_0 max abs err "
        f"{q4_err:.3g} (rows independent of b: {q4_rows_ok}), flash "
        f"{fl_err:.3g}, attn_decode {ad_err:.3g} (attn lane map "
        f"{attn_lay_err:.3g}), Q8_0 {q8_err:.3g} (rows "
        f"independent of b), mlp_fused_q8 {mlp_err:.3g}, gpt2_layer "
        f"{layer_err:.3g}, mlp_fused_silu_q4 {silu_err:.3g}, llama_layer "
        f"{llayer_err:.3g}; matmul_q {max(mq_errs.values()):.3g} (7 "
        f"formats, rows independent of b), matmul_int_dot "
        f"{max(ib_errs.values()):.3g} (5 formats); flash entries "
        f"{ {k: float(f'{v:.3g}') for k, v in fl2_err.items()} } (uncached, "
        f"softcap, f16, D 8-256, gradients, HVP); quantizers on the card "
        f"vs the CPU, share of blocks differing: "
        f"{max(q_card.values()):.3g}; launch geometries bit-equal to the "
        f"default in {geom_cases} cases; rms rows differing alone "
        f"vs in a batch of {SLOTS}: "
        f"{ {k: v['rms_rows_differ'] for k, v in rms_rows.items()} }")

    cfg = llama.LLAMA_7B
    # one tree for paths a, b and d: the fused routes' entries are stripped
    # for a and b (the whole-block route's wo copies are drawn after every
    # other weight, so the rest is the tree the switches-off call gives)
    params_d = llama.synthetic_q4_0_params(cfg, seed=SEED, mlp_fused=True,
                                           layer_fused=True)
    params = strip_routes(params_d, ("mlp_fused", "layer_fused"))
    prompt = torch.randint(0, cfg.n_vocab, (1, PROMPT_LEN), generator=gen,
                           device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    toks, counts = run_main_path(cfg, params, prompt)
    peak = torch.cuda.max_memory_allocated()
    # The main path's own settings (Q8_0 activations, bf16 cache): a one-ulp
    # f32 difference between the paths can move a Q8 or bf16 rounding by a
    # whole step, and 32 layers carry that to the logits (measured 0.04 on
    # logits up to 5): tol 0.1. Weight-only with an f32 cache, its own
    # generate run: the paths differ in f32 summation order alone
    # (measured 6e-6): tol 1e-3.
    compare_plain(llama, cfg, params, prompt, quant_acts=True,
                  cache_dtype=torch.bfloat16, tol=0.1, toks=toks)
    compare_plain(llama, cfg, params, prompt, quant_acts=False,
                  cache_dtype=torch.float32, tol=1e-3)
    log(f"[4/6] a. Llama-7B Q4_0: {PROMPT_LEN}-token prompt + {N_NEW} "
        f"greedy tokens through the kernels; launches {counts}")
    eng, serve = run_serving(cfg, params)
    serve_counts = serve["launches"]
    # the main settings again (Q8_0 activations), an INT8 cache whose
    # rounding a one-ulp difference can move a whole step, like a Q8 one:
    # tol 0.1, as for the b = 1 path
    replay_err, serve_prof = replay_serving(cfg, params, tol=0.1)
    http = http_check(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    log(f"[4/6] b. serving: {serve['requests']} requests through "
        f"{SLOTS} slots, launches {serve_counts}; replay vs plain max abs "
        f"err {replay_err:.3g}; HTTP: {http['requests']} requests answered")

    # GPT-2 Q8_0 at b = 1, 124M and 774M. Tolerances as for llama: under the
    # path's own settings (the prefill's Q8_0 activations, bf16 cache rows) a
    # one-ulp difference can move a rounding by a whole step (measured
    # 0.036-0.040 on logits up to 4.9): tol 0.1, 2.5 times that; weight-only
    # with an f32 cache the paths differ in f32 summation order alone
    # (measured 6e-6): tol 1e-3. The synthetic stream keeps changing
    # (run_gpt2_path holds that), so the 8 tokens are 8 different argmaxes.
    g_models = {}
    for tag, gcfg in gpt2_configs():
        gparams = gpt2.synthetic_q8_0_params(gcfg, seed=SEED)
        gprompt = torch.randint(0, gcfg.n_vocab, (1, PROMPT_LEN),
                                generator=gen, device=dev, dtype=torch.int32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # llama's weights stay resident
        torch.cuda.reset_peak_memory_stats()
        gtoks, gcounts = run_gpt2_path(tag, gcfg, gparams, gprompt)
        gpeak = torch.cuda.max_memory_allocated() - base \
            + gpt2_weight_bytes(gparams)
        e1 = compare_plain(gpt2, gcfg, gparams, gprompt, quant_acts=True,
                           cache_dtype=torch.bfloat16, tol=0.1, toks=gtoks)
        e2 = compare_plain(gpt2, gcfg, gparams, gprompt, quant_acts=False,
                           cache_dtype=torch.float32, tol=1e-3)
        g_models[tag] = (gcfg, gparams, gprompt, gcounts, gpeak)
        log(f"[4/6] c. GPT-2 {tag} Q8_0: {PROMPT_LEN}-token prompt + {N_NEW} "
            f"greedy tokens through the kernels; launches {gcounts}; vs "
            f"plain max abs err {e1:.3g} (path settings), {e2:.3g} "
            f"(weight-only, f32 cache)")

    # d. Llama-7B through the fused routes. Both switches, flat bf16 cache:
    # the prompt on the per-op loop (wqkv, wo and the LM head through the
    # Q4_0 kernel, flash, the fused MLP at 16 rows), every decode step one
    # whole-block call a layer and the LM head.
    L = cfg.n_layer
    ftoks, fcounts = run_fused_path(
        cfg, params_d, prompt, "mlp_fused + layer_fused, flat bf16 cache",
        N_NEW, {"llama_layer": L * N_NEW, "mlp_fused_silu_q4": L,
                "flash_attn": L, "matmul_q4_0": 2 * L + 1 + N_NEW},
        flat=True)
    # The fused MLP alone, head-major cache (path a's route with one call
    # in place of w_gate_up, silu and w_down): kernel 9 at b = 1.
    params_m = strip_routes(params_d, ("layer_fused",))
    mtoks, mcounts = run_fused_path(
        cfg, params_m, prompt, "mlp_fused, head-major bf16 cache", MLP_STEPS,
        {"mlp_fused_silu_q4": L * (1 + MLP_STEPS), "flash_attn": L,
         "matmul_q4_0": (2 * L + 1) * (1 + MLP_STEPS)})
    # Tolerances as for path a. The whole-block route quantizes no
    # activation, but its prompt and bf16 cache rows do round: tol 0.1 under
    # the path's own settings; weight-only with an f32 cache the paths differ
    # in f32 summation order alone: tol 1e-3.
    f_errs = [
        compare_plain(llama, cfg, params_d, prompt, quant_acts=True,
                      cache_dtype=torch.bfloat16, tol=0.1, toks=ftoks,
                      route="both", flat=True),
        compare_plain(llama, cfg, params_d, prompt, quant_acts=False,
                      cache_dtype=torch.float32, tol=1e-3, route="both",
                      flat=True),
        compare_plain(llama, cfg, params_m, prompt, quant_acts=True,
                      cache_dtype=torch.bfloat16, tol=0.1, toks=mtoks,
                      route="mlp_fused"),
        compare_plain(llama, cfg, params_m, prompt, quant_acts=False,
                      cache_dtype=torch.float32, tol=1e-3,
                      route="mlp_fused")]
    log(f"[4/6] d. Llama-7B fused routes: {PROMPT_LEN}-token prompt + "
        f"{N_NEW} greedy tokens, launches {fcounts}; fused MLP alone + "
        f"{MLP_STEPS} tokens, launches {mcounts}; vs plain max abs err "
        f"{f_errs[0]:.3g}, {f_errs[2]:.3g} (path settings), {f_errs[1]:.3g}, "
        f"{f_errs[3]:.3g} (weight-only, f32 cache)")

    # e. BASELINE config 3: Llama-7B with every matmul weight and both
    # tables in Q4_K, then in Q6_K (random from the seed, quantized on the
    # card), an INT8 flat cache of 2048 rows, b = 1: the 16-token prompt
    # (kernel A, flash over the fresh rows) and 32 greedy tokens (kernel A
    # in every matmul, attn_decode in every layer). Tolerances as path a's;
    # the INT8 cache rounds a one-ulp difference by a whole step, as Q8 does.
    e_models, e_counts, e_errs = {}, {}, {}
    for fmt in E_FORMATS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        eparams = llama.synthetic_params(cfg, GType[fmt], seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        etoks, e_counts[fmt] = run_fused_path(
            cfg, eparams, prompt, f"e {fmt}, int8 flat cache", N_NEW,
            {"matmul_q": (4 * L + 1) * (1 + N_NEW), "flash_attn": L,
             "attn_decode": L * N_NEW}, tag="llama_kquant_path", int8=True)
        epeak = torch.cuda.max_memory_allocated() - base
        e_errs[fmt] = [
            compare_plain(llama, cfg, eparams, prompt, quant_acts=True,
                          cache_dtype=torch.bfloat16, tol=0.1, toks=etoks,
                          route=f"e {fmt}, int8 flat cache", int8=True),
            compare_plain(llama, cfg, eparams, prompt, quant_acts=False,
                          cache_dtype=torch.float32, tol=1e-3,
                          route=f"e {fmt}, f32 head-major cache")]
        e_models[fmt] = (eparams, epeak)
        log(f"[4/6] e. Llama-7B {fmt} + INT8 KV: {PROMPT_LEN}-token prompt + "
            f"{N_NEW} greedy tokens, launches {e_counts[fmt]}; vs plain max "
            f"abs err {e_errs[fmt][0]:.3g} (path settings), "
            f"{e_errs[fmt][1]:.3g} (weight-only, f32 cache)")
    kq_counts = {k: sum(c[k] for c in e_counts.values()) for k in counts}
    # f. the other formats at full width and F_LAYERS layers
    fmt_counts, f_cmp = run_format_paths(cfg, prompt, gen)
    log(f"[4/6] f. Llama-7B widths, {F_LAYERS} layers, {PROMPT_LEN}-token "
        f"prompt + {F_NEW} tokens: f1 {', '.join(A_FORMATS[:5])} (matmul_q), "
        f"f2 GGML_TPU_INT_DOT=1 {', '.join(B_FORMATS)}; launches "
        f"{fmt_counts}; vs plain max abs err {max(f_cmp.values()):.3g}")

    # g. training: GPT-2 124M, bf16, TRAIN_STEPS Adam steps through
    # optim.opt_fn, the cached flash entry's Function in every layer
    train, g_counts = run_train_path(dev, smi, gpt2.GPT2_124M)
    log(f"[4/6] g. GPT-2 124M training, B {TRAIN_B} x S {TRAIN_S}: losses "
        f"{[round(x, 4) for x in train['losses']]} -> "
        f"{train['loss_after']:.4f}; flash launches a step "
        f"{train['flash_launches_per_step']:.0f}; launches {g_counts}")
    # h. the graph layer: Test3 by ggml_opt (L-BFGS), a flash decoder's
    # forward, backward and opt() (the uncached entry)
    h1 = run_graph_test3(dev, smi)
    h2cmp, h2, h_counts = run_graph_decoder(dev, gen, smi)
    log(f"[4/6] h. graph layer: Test3 {h1['result']}, max weight err "
        f"{h1['max_abs_weight_err']:.3g} in {h1['seconds']:.2f} s; decoder "
        f"kernel vs plain loss err {h2cmp['loss_rel_err']:.3g}, grad rel L2 "
        f"{h2cmp['grad_rel_l2_max']:.3g}; opt() losses "
        f"{[round(x, 5) for x in h2['losses']]}; launches {h_counts}")
    # GPT-2 124M behind the engine with an INT8 (head-major) cache
    gserve, gs_counts = run_gpt2_int8_serving(*g_models["124M"][:2])
    log(f"[4/6] GPT-2 124M INT8 serving: {SERVE_G_REQS} requests through "
        f"{SERVE_G_SLOTS} slots, cache {gserve['cache_int8_flat_shape']}, "
        f"tokens equal to the plain engine's: {gserve['tokens_equal_plain']}"
        f"; launches {gs_counts}")

    # the tuning path: the probes (sites 12-17), the tune table against the
    # default geometry, and path i through the tuned dispatch
    probes, probe_counts = run_probe_path(dev)
    cp = probes["dq"]["copy"]
    log(f"[4/6] tuning probes in {probes['seconds']:.1f} s: i2f bit-equal to "
        f"prmt, half2 within its bar; copy {cp[0]['gb_s']:.0f} GB/s (8 MB), "
        f"{cp[1]['gb_s']:.0f} GB/s (1 GiB); byte order "
        f"{probes['swar']['byte_order']['order']}; K-major matvec agrees; "
        f"f16 decode and block maps exact; bad entries "
        f"{probes['scale']['bad_entry_map']['bad_entries']}; launches "
        f"{ {k: v for k, v in probe_counts.items() if v} }")
    tcheck = check_tune_table(dev, gen, smi)
    log(f"[4/6] tune table ({tcheck['card']}): {tcheck['entries']} entries "
        f"timed against the default in {tcheck['seconds']:.1f} s: median "
        f"gain {tcheck['gain_b1_median']:.3f} at b = 1 (read there), "
        f"{tcheck['gain_b8_median']:.3f} at b = 8 (not read; "
        f"{tcheck['entries_slower_at_b8']} entries slower); lookup "
        f"{tcheck['lookup_us_per_launch']:.2f} us a launch")
    i_dec, i_counts = run_13b_path(dev, gen, smi)
    log(f"[4/6] i. LLAMA_13B Q4_0: {PROMPT_LEN}-token prompt + {I_NEW} "
        f"greedy tokens, launches {i_counts}; geometry by shape "
        f"{ {k: v['geometry'] for k, v in i_dec['geometry_by_shape'].items()} }"
        f"; {i_dec['window_tok_s']:.2f} tok/s, {i_dec['roofline_share']:.4f} "
        f"of the HBM roofline, device idle share "
        f"{i_dec['device_idle_share']}")

    q4_row = time_q4_0(dev, gen, counts)
    q4_row["max_abs_err"] = q4_err
    fl_row = time_flash(dev, gen, counts)
    fl_row["max_abs_err"] = fl_err
    ft = time_flash_train(dev, gen)
    fl_row.update({
        "train_g_ms": ft["cached_ms"], "train_g_softcap_ms":
        ft["cached_softcap_ms"], "train_g_plain_ms": ft["plain_ms"],
        "train_g_library_ms": ft["sdpa_ms"],
        "train_g_bound_ms": ft["cached_bound_ms"], "bwd_ms": ft["bwd_ms"],
        "library_bwd_ms": ft["sdpa_bwd_ms"],
        "softcap_gradient_max_abs_err": max(fl2_err["cached"],
                                            fl2_err["grad"])})
    unc_row = {"name": "flash_attn_uncached", "route": "cuda",
               "source": "ggmlsharp_tpu_torch/csrc/flash_attn.cu",
               "replaces": "ggmlsharp_tpu/kernels/flash.py:104",
               "ms": ft["uncached_ms"], "plain_ms": ft["uncached_plain_ms"],
               "bound_ms": ft["uncached_bound_ms"],
               "bound_by": ft["bound_by"], "library_ms": ft["sdpa_ms"],
               "max_abs_err": fl2_err["uncached"], "bwd_ms": ft["bwd_ms"],
               "library_bwd_ms": ft["sdpa_bwd_ms"],
               "unit": "one causal call at path g's shape: B 8 x H 12, S 128, "
                       "D 64, bf16 q/k/v and out (entry flash.py:170); "
                       "library = SDPA is_causal; bwd = the Function's dense "
                       "recompute vs SDPA's backward"}
    ad_row = time_attn_decode(dev, gen, serve_counts)
    ad_row["max_abs_err"] = ad_err
    lay = time_attn_layout(dev, gen)
    ad_row["attn_layout_max_abs_err"] = attn_lay_err
    ad_row["attn_layout_ms"] = lay[0]["attn_layout_ms"]
    ad_row["heads_layout_bf16_ms"] = lay[0]["heads_layout_ms"]
    q8_row = time_q8_0(dev, gen)
    q8_row["max_abs_err"] = q8_err
    mlp_row = time_mlp_fused(dev, gen)
    mlp_row["max_abs_err"] = mlp_err
    layer_row = time_gpt2_layer(dev, gen)
    layer_row["max_abs_err"] = layer_err
    silu_row = time_mlp_fused_silu(dev, gen)
    silu_row["max_abs_err"] = silu_err
    llayer_row = time_llama_layer(dev, gen)
    llayer_row["max_abs_err"] = llayer_err
    mq_row = time_matmul_q(dev, gen, kq_counts)
    mq_row["max_abs_err"] = max(mq_errs.values())
    mq_row["max_abs_err_by_format"] = mq_errs
    ib_row = time_int_dot(dev, gen, fmt_counts)
    ib_row["max_abs_err"] = max(ib_errs.values())
    ib_row["max_abs_err_by_format"] = ib_errs
    for r in time_attn_decode_b1(dev, gen):
        ad_row[f"b1_T{r['T']}_ms"] = r["ms"]
        ad_row[f"b1_T{r['T']}_bound_ms"] = r["bound_ms"]
        ad_row[f"b1_T{r['T']}_plain_ms"] = r["plain_ms"]
        ad_row[f"b1_T{r['T']}_library_ms"] = r["library_ms"]
    rows = (q4_row, fl_row, ad_row, q8_row, mlp_row, layer_row, silu_row,
            llayer_row, mq_row, ib_row, unc_row, *tune_rows(probes))
    g124, g774 = g_models["124M"][3], g_models["774M"][3]
    for row in rows:
        name = row["name"]
        row["launches_llama_b1"] = counts[name]
        row["launches_serving"] = serve_counts[name]
        row["launches_gpt2_124m"] = g124[name]
        row["launches_gpt2_774m"] = g774[name]
        row["launches_llama_fused"] = fcounts[name]
        row["launches_llama_mlp_fused"] = mcounts[name]
        row["launches_llama_kquant"] = kq_counts[name]
        row["launches_llama_formats"] = fmt_counts[name]
        row["launches_train_g"] = g_counts[name]
        row["launches_graph_h"] = h_counts[name]
        row["launches_gpt2_int8_serving"] = gs_counts[name]
        row["launches_tuning_probes"] = probe_counts[name]
        row["launches_llama_13b"] = i_counts[name]
        # the count on the first main path that runs the kernel
        row["launches"] = next(c[name] for c in (counts, serve_counts, g124,
                                                 fcounts, kq_counts,
                                                 fmt_counts, g_counts,
                                                 h_counts, probe_counts,
                                                 i_counts) if c[name])
    log("[5/6] kernel times taken")

    llama_wbytes = sum(v.nbytes() for blk in params["blocks"] for key, v in
                       blk.items() if key.startswith("w")) \
        + params["output"].nbytes()
    dec = measure_decode(llama, cfg, params, prompt, llama_wbytes,
                         cfg.n_head_kv * cfg.head_dim)
    dec["peak_mem_gb"] = peak / 1e9
    dec["q4_0_share_of_step"] = q4_row["ms"] / dec["step_ms_median"]
    dec["card"] = smi
    emit({"decode": dec})
    st = serve["stats"]
    tok_s = SERVE_REQS * SERVE_NEW / serve["seconds"]
    # batched roofline: one pass over the weights serves SLOTS tokens
    serve_roof = SLOTS * HBM_BYTES_S / dec["weight_bytes"]
    srv = {"card": smi, "slots": SLOTS, "requests": SERVE_REQS,
           "prompt_tokens": SERVE_PLEN, "new_tokens": SERVE_NEW,
           "max_len": SERVE_MAX_LEN, "kv": "int8 flat",
           "tokens_per_s": tok_s, "seconds": serve["seconds"],
           "mean_ttft_s": st["mean_ttft_s"],
           "mean_latency_s": st["mean_latency_s"], "ticks": st["ticks"],
           "decode_forwards": st["decode_forwards"],
           "prefill_dispatches": st["prefill_dispatches"],
           "peak_mem_gb": serve["peak_mem_gb"],
           "roofline_tok_s": serve_roof,
           "roofline_share": tok_s / serve_roof,
           "decode_step": serve_prof}
    emit({"serving": srv})
    log(f"[6/6] decode b=1: {dec['window_tok_s']:.1f} tok/s, "
        f"{dec['roofline_share']:.3f} of the HBM roofline, device idle "
        f"share {dec['device_idle_share']}; serving {SLOTS} slots: "
        f"{tok_s:.1f} tok/s, {srv['roofline_share']:.4f} of the batched "
        f"roofline, mean TTFT {st['mean_ttft_s']:.2f} s, mean latency "
        f"{st['mean_latency_s']:.2f} s ({smi})")
    fdec = measure_decode(llama, cfg, params_d, prompt, llama_wbytes,
                          cfg.n_head_kv * cfg.head_dim, flat=True)
    fdec.update(route="mlp_fused + layer_fused, flat bf16 cache", card=smi,
                llama_layer_share_of_step=llayer_row["ms"] * cfg.n_layer
                / fdec["step_ms_median"],
                unfused_window_tok_s=dec["window_tok_s"])
    emit({"llama_fused_decode": fdec})
    log(f"[6/6] Llama-7B whole-block route b=1: "
        f"{fdec['window_tok_s']:.1f} tok/s ({dec['window_tok_s']:.1f} "
        f"unfused), {fdec['roofline_share']:.4f} of the HBM roofline, step "
        f"median {fdec['step_ms_median']:.3f} ms, device idle share "
        f"{fdec['device_idle_share']}")
    del params, params_d, params_m
    torch.cuda.empty_cache()
    ekv = cfg.n_head_kv * cfg.head_dim
    for fmt, (eparams, epeak) in e_models.items():
        wbytes = sum(v.nbytes() for blk in eparams["blocks"]
                     for key, v in blk.items() if key.startswith("w")) \
            + eparams["output"].nbytes()
        edec = measure_decode(llama, cfg, eparams, prompt, wbytes, ekv,
                              kv_row_bytes=ekv + 4 * cfg.n_head_kv, int8=True)
        tok = mq_row if fmt == "Q4_K" else mq_row["q6_k_token"]
        edec.update(format=fmt, cache="int8 flat, 2048 rows", card=smi,
                    peak_mem_gb=epeak / 1e9,
                    matmul_q_share_of_step=tok["ms"] / edec["step_ms_median"])
        emit({"llama_kquant_decode": edec})
        log(f"[6/6] e. Llama-7B {fmt} + INT8 KV b=1: "
            f"{edec['window_tok_s']:.1f} tok/s, {edec['roofline_share']:.4f} "
            f"of the HBM roofline ({edec['roofline_tok_s']:.0f} tok/s on "
            f"{wbytes / 1e9:.3f} GB of weights), step median "
            f"{edec['step_ms_median']:.3f} ms, device idle share "
            f"{edec['device_idle_share']}")
    del e_models, eparams
    torch.cuda.empty_cache()
    for tag, (gcfg, gparams, gprompt, _, gpeak) in g_models.items():
        gdec = measure_decode(gpt2, gcfg, gparams, gprompt,
                              gpt2_weight_bytes(gparams), gcfg.n_embd)
        gdec.update(config=tag, peak_mem_gb=gpeak / 1e9, card=smi)
        emit({"gpt2_decode": gdec})
        log(f"[6/6] GPT-2 {tag} decode b=1: {gdec['window_tok_s']:.1f} "
            f"tok/s, {gdec['roofline_share']:.4f} of the HBM roofline "
            f"({gdec['roofline_tok_s']:.0f} tok/s), step median "
            f"{gdec['step_ms_median']:.3f} ms, device idle share "
            f"{gdec['device_idle_share']}")
    train["flash_share_of_step"] = ft["fwd_bwd_ms"] * gpt2.GPT2_124M.n_layer / (
        train["step_ms_median_2_4"])
    emit({"train": train})
    log(f"[6/6] g. GPT-2 124M training B {TRAIN_B} x S {TRAIN_S} bf16: "
        f"step median {train['step_ms_median_2_4']:.1f} ms, "
        f"{train['tokens_per_s']:.0f} tok/s, {train['bf16_peak_share']:.4f} "
        f"of the bf16 dense peak, peak memory {train['peak_mem_gb']:.2f} GB "
        f"({smi})")
    log(f"total {time.perf_counter() - t_start:.0f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "unit",
            "launches_llama_b1", "launches_serving", "launches_gpt2_124m",
            "launches_gpt2_774m", "launches_llama_fused",
            "launches_llama_mlp_fused", "launches_llama_kquant",
            "launches_llama_formats", "launches_train_g", "launches_graph_h",
            "launches_gpt2_int8_serving", "launches_tuning_probes",
            "launches_llama_13b")
    extra = ("attn_layout_max_abs_err", "attn_layout_ms",
             "heads_layout_bf16_ms",  # kernel 3's second lane map
             "b1_T64_ms", "b1_T64_bound_ms", "b1_T64_plain_ms",
             "b1_T64_library_ms", "b1_T2048_ms", "b1_T2048_bound_ms",
             "b1_T2048_plain_ms", "b1_T2048_library_ms",  # kernel 3, B = 1
             "q6_k_token", "w_gate_up_b1_ms", "w_gate_up_ms",
             "max_abs_err_by_format",
             # kernel 2 at path g's shape: the cached entry, softcap, the
             # backward (the Function's dense recompute) against SDPA's
             "train_g_ms", "train_g_softcap_ms", "train_g_plain_ms",
             "train_g_library_ms", "train_g_bound_ms", "bwd_ms",
             "library_bwd_ms", "softcap_gradient_max_abs_err",
             # sites 12-17 (the tuning probes)
             "prmt_ms", "by_shape_ms", "prmt_by_shape_ms",
             "i2f_bit_equal_prmt", "half2_err_over_bar", "half2_terms_t",
             "gb_s", "ms_1gib", "gb_s_1gib", "library_ms_1gib",
             "library_gb_s_1gib", "plain_ms_1gib", "bound_ms_1gib", "order",
             "row_default_ms", "row_tuned_ms", "by_shape")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
