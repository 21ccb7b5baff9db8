#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ggmlsharp_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each failing loudly (nothing falls back to the CPU or to a plain
version):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ with nvcc, one process a source;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it (kernel 3 also against its split algorithm,
     _decode_ref_split, at the splits its wrapper chooses), kernels 2 and 3
     at ragged edges, and every launch geometry of the three dequant-matmul
     sources against the default bit for bit; the Q4_0 and kernel A
     dequant-matmuls at b 1, 2, 5, 8, 16, 128 (both instances) at every 7B
     shape and 4099 x 11008, and a row's bits equal at every b that takes
     the multi-row instance; the Q8_0 one likewise at b 1, 2, 5, 8, 16,
     64, 128, Q8_0 and f32 x, at every GPT-2 shape and 100 x 352; f32 x
     in both mm_dot modes, and kernel 3 in both, each against the plain
     version of the same mode; the fused SwiGLU MLP (both instances) at
     1-64 rows at 7B and at E 384, F 640, one row at 13B; the fused GELU MLP
     (both instances) at 1-64 rows at both GPT-2 widths and E 384 and one
     row at E 2048 (its shares in a ring), Q8_0 and f32 x, a row's bits
     equal at every row count of the multi-row instance; the one-row
     instances of both, with the GPT-2 block kernel between them on one
     stream, three times back to back and in a CUDA graph replayed twice,
     every launch's bits equal to the first's;
     the whole-block llama kernel at npast 0 to 2047, a ragged T, bf16 and
     f32 caches, MHA and GQA; decode attention at head dims 32 and 256
     (path m2's step: B 96, 6 KV heads of 32) and n_rep 40; flash at D 32
     (path m1's training forward and prefill); path m1's w_down (192 x 512)
     in Q4_0, Q4_K, Q6_K and Q8_0 at 127 and 128 rows; the bucket
     switch's selector kernel (run alone) against its plain version on
     random lengths of 1-96 slots, one and two bounds, T 1024 and 2048;
  4. the paths, each with the launch counters reset just before and
     read just after, and each held against its plain path. The decode
     step runs captured (models.captured: one CUDA graph a length bucket,
     the launches counted through the replay accounting; generate's
     prefill and steps, and speculative_generate's prefills and rounds,
     from the graph cache, kept across calls); every greedy
     sampling.generate of paths a-l is run first in the eager form
     (captured.disabled(), on a copy of its cache, its launches not
     counted), and the captured call must give its tokens bit for bit and
     its launches kernel by kernel (eager_twins); b and s serve their
     requests in both forms likewise; a step with a host sync, and a
     per-stream buffer made inside a capture, must raise. Training and
     evaluation run captured too (an opt_adam / opt_torch call one graph,
     its first iteration the eager warm-up; Graph.compute one graph a
     topology and input spec; a perplexity call one graph): g's and h2's
     runs each beside their eager form:
     a. b = 1 decode: Llama-7B (full width and depth, random Q4_0 weights
        from a seed), a 16-token prompt and 32 greedy tokens through
        sampling.generate;
     a2. the graph cache (models.captured.entry) on path a: generate 4
        times with fresh caches of one spec from an empty cache, calls 2-4
        making no capture, each call's tokens, launches and live cache rows
        equal to the eager form's, host seconds a call; the prefill's ms in
        both forms; two calls on two caches with different prompts, each
        cache holding its own prompt's rows; memory reserved after each
        call (no creep). Every progress line prints the memory reserved and
        the graph cache's trees, entries and home caches;
     a3. t_eff=None (JAX's in-graph lax.switch) on path a's tree over a
        1024-row cache: make_decode_fns' prefill (240 tokens) and 300
        steps, and make_greedy_step's, each ONE parent graph (a selector
        kernel, csrc/graph_switch.cu, and a conditional node over one body
        a bucket: 256, 512, 1024 all visited), replayed under
        torch.cuda.set_sync_debug_mode("error"); tokens and launches equal
        to the t_eff-passing form's (a graph a bucket); then k1's round
        (draft = target) at t_eff = d_eff = None against the t_eff-passing
        rounds until the target passes 520 rows; host ms a step (a round)
        and tok/s of each form on a second pass with every graph made; the
        parent's design printed;
     b. serving: serving.Engine over the same model with an INT8 flat KV
        cache, 8 slots, 24 requests of 16 prompt tokens and 24 new tokens
        each; then a replay of its admission prefill and decode steps
        through the kernels and the plain path, and three concurrent HTTP
        requests through serving.EngineServer;
     c. GPT-2 Q8_0 greedy decode at b = 1, at the full width and depth of
        GPT-2 124M and of GPT-2 774M (random Q8_0 weights from a seed, flat
        bf16 cache): a 16-token prompt (per-matmul Q8_0 kernel, flash, the
        fused MLP kernel's multi-row instance) and 32 greedy tokens (one
        whole-block kernel call a layer) through sampling.generate; then
        (c2) over the head-major cache, which takes the per-op route, the
        prompt and 8 greedy tokens (the Q8_0 kernel and the fused MLP at one
        row);
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
        layer, its backward a dense recompute, every product in bf16 on
        the tensor cores with f32 accumulation) in the eager form and then
        captured, losses and launches held to each other;
     h. the graph layer: the reference's Test3 (4096 x 256 L-BFGS fit) by
        ggml_opt on the card (opt_lbfgs_jit: one probe captured into a CUDA
        graph, replayed in batches) and by the host loop (opt_lbfgs_host)
        on the same data, the two held to each other; Rosenbrock by
        opt_lbfgs_jit on the card against its CPU run under each line
        search; a fun_vg with a host sync, whose capture must raise; then a
        graph-API decoder (E 768, 12 heads, S 128, 2 layers) with
        flash_attn: forward, backward graph against the plain route and
        against its eager form, computed again after set_data on the
        tokens (a replay, no capture), and 4 Adam steps of opt() (the
        uncached flash entry) in both forms;
     and GPT-2 124M behind serving.Engine with an INT8 (head-major) cache,
     against the same engine's plain run; then the tuning path:
     the TPU probes' counterparts (probes/: the three Q4_UNPACK builds of
     matmul_q4_0.cu, i2f bit-equal to prmt and half2 within its bar; the
     copy ceiling at 8 MB and 1 GiB; the byte map; the K-major matvec; the
     f16 decode, block maps and bad-entry map), the tune table's entries
     timed against the default geometry at b = 1, where dispatch reads
     them (its card checked against this one), and the host cost of the
     table's lookup, and
     i. LLAMA_13B Q4_0 (full width, depth cut to 20 of 40 layers for the
        script's time limit, random weights quantized on the card) at
        b = 1: a 16-token prompt and 8 greedy tokens, every
        b = 1 matmul through matmul_q4_0 at the tune table's geometry for
        its shape (the prompt's at the default); held against the plain
        route; tok/s and roofline share;
     j. a model from files, each removed afterwards: j1 path a's tree
        (unfused, unpadded) and a vocabulary trained on
        tests/data/tiny_corpus.txt (padded to 32000 pieces) written to a
        GGUF by io.save_gguf_llama (~3.8 GB, streamed), loaded onto the
        card with io.load_gguf_llama: wire digests, both encoders on a
        sentence, path a's prompt logits bit for bit and its 32 greedy
        tokens, decoded; perplexity over two 256-token windows of the
        corpus (matmul_q4_0's multi-row instance and flash, against the
        plain route; captured, then eager), and a "text" request through
        EngineServer; j2 path
        c's GPT-2 124M weights written as HF safetensors (F32 matrices,
        BF16 vectors), io.load_hf_gpt2, Q8_0 on the card, path c's route
        (kernels 4, 8, 11); j3 path g's trained parameters and a Q4_0 tree
        through io.save_checkpoint / load_checkpoint, bit for bit;
     k. speculative decoding (models.speculative, k = SPEC_K), each run
        in both forms (eager, then its rounds captured: one CUDA graph a
        length bucket; the engine's admissions too), the captured form's
        tokens and launches equal to the eager form's: k1 Llama-7B
        Q4_0 with itself as the draft at b = 1 (bf16 head-major caches; the
        16-token prompt, 32 tokens), held to path a's tokens on decided
        positions, k + 1 tokens on every round whose drafts are all
        decided; k2 GPT-2 774M Q8_0 with a GPT-2 124M Q8_0 draft (flat float
        caches: the draft's steps through the whole-block kernel, the 5-row
        verify through kernels 4 and 8), held to the 774M's per-op greedy
        decode (GGML_TPU_LAYER_FUSED=0) on decided positions, then one
        rejection-sampled run (its generator registered with the graph, the
        stream equal to the eager one); k3 the speculative engine over path
        b's config (draft = target, INT8 flat caches, 8 slots; 24 greedy
        requests, one through a registered prefix, and two at temperature
        0.8), held to the same engine on plain forwards on decided tokens,
        then an HTTP check; the phase's captured.COUNTS;
     l. GPT-J 6B Q4_0 (full width, depth cut to 8 of 28 layers for the
        script's time limit, random weights quantized on the card) at
        b = 1: the 16-token prompt (kernel 1's multi-row
        instance, flash at D 256) and 32 greedy tokens, held against the
        plain route, then the whole tree through a GGUF (leaves bit for bit,
        the same tokens);
     m. the perplexity chain (eval.chain, scripts/ppl_chain_torch.py's
        defaults for seed 0 on a corpus of 1500 sentences in place of 3000):
        m1 a 4L/192E Llama trained by up to 300 full-batch Adam steps (the
        chain's relative-change rule, eps_f 1e-5, may stop it sooner) on the
        corpus's first third (flash at D 32 under
        autograd, its first step held against the plain route; captured,
        and a 4-step run in both forms for the step's ms), written with
        its vocabulary to a GGUF, reloaded and re-tokenized exactly, and
        scored on the held-out ids at fp32 and in four formats (w_down
        through the dequant-matmuls' multi-row instances), fp32 and Q4_0
        held against the plain route; m2 the decode-path KV scoring over
        m1's GGUF (eval.kv_quality: 96 chunks x 127 steps; attn_decode at
        D 32 over bf16 and int8 flat caches; each cache's step one captured
        graph), held against its eager form (captured.disabled(): every
        row's ppl within 1e-6 relative, argmax agreement equal; the ms a
        step of both) and against the plain route;
     n. the user examples in-process on the card (serve_torch at GPT-2 124M
        three ways, http_server_torch, quantize_model_torch's round trip,
        train_graph_torch, graph_transformer_torch), OpProfiler over path
        h2's decoder graph against Graph.compute, and GgmlAdam through
        opt_torch against opt_adam on Test2's objectives, both captured;
     p. the parallel layer, its ranks spawned by torch.multiprocessing
        (a failed rank or a collective past its timeout fails the script):
        p0 a world of one on NCCL, tiny Llama Q4_0 and GPT-2 Q8_0 through
        the TP forward, the TP engine, forward_pp, the ring route, the
        overlapped matmul and the sharded checkpoint pair, bit for bit
        against the unsharded port where the route is the same function;
        then (b) path a's Llama-7B Q4_0 served by Engine(mesh=) on the
        model = 1 mesh, captured over NCCL (its decode step and admissions
        CUDA graphs, the collectives in them) and eager, tokens and
        launches equal, tokens held to the single-device engine's on
        decided tokens, captures, replays, host and device ms a decode
        step of each; the tiny GPT-2 Q8_0 TP engine likewise (kernel 4 in
        its graphs); (c) examples/train_distributed_torch.py's train() for
        10 steps captured (one CapturedStep over NCCL) and eager, losses
        bit-equal, each resumed from its own checkpoint for 5, equal;
        p1 a world of two on gloo, both ranks on this card, path a's
        Llama-7B Q4_0: (a) Engine(mesh=) at model 2 (bf16 head-major cache
        of the rank's 16 KV heads, 4 slots, 8 requests of 16 + 16 greedy
        tokens), both ranks' tokens equal and held to the single-device
        engine's on decided tokens, (b) llama.forward_pp over 2 stages of
        16 blocks (B 4, S 128, 2 microbatches) against the single-device
        forward, (c) a 256-token prefill under GGML_TPU_ATTN=ring over a
        2-rank sequence mesh against the legacy route, (d) the overlapped
        row-parallel matmul at w_down's shape against mul_mat on one
        device; each part's launches on each rank, host and device ms a
        step and the bytes gloo staged; p2 worlds of four on gloo (data 2
        x model 2): parallel.dryrun.run(4) beside
        examples/train_distributed_torch.py for 20 steps (two worlds at
        once), then the example resumed from its sharded checkpoint for 5
        by a new world started as the dry run ends (p0 beside it), which
        waits for the first run's end; p1's single-device reference runs
        while p1's ranks start; p1's TP engine and p2's training step run
        eagerly (gloo stages through the host), which both assert;
  5. each kernel's time at the paths' shapes (CUDA events), beside its
     plain version, one PyTorch library call and its bound; kernel 2 also
     at path g's shape, both entries, softcap, and its backward against
     SDPA's; kernels 2 and 3 at every shape a path runs them
     (FLASH_TIMING, ATTN_DECODE_TIMING); kernel 1 at GPT-J 6B's four
     shapes at 1 and 5 rows (a token, a verify);
  6. decode tokens/s at batch 1, its share of the HBM roofline, prefill
     time, peak device memory, and a torch.profiler window of decode steps
     (device time, launches and host operator calls a step, idle share),
     in both forms (eager, then captured: host ms a step and its p84,
     window tok/s, launches a step, captures, replays and capture seconds)
     for a, c 124M, d1 and b's engine and decode step;
     serving tokens/s, time to first token, latency, ticks, peak memory
     and the share of the batched roofline; the same decode measurements
     for GPT-2 124M and 774M, for Llama-7B on its whole-block route and
     for path e in Q4_K and Q6_K; path g's step time, tokens/s, share of
     the bf16 dense peak, idle share, capture seconds and peak memory in
     both forms; k1's round in both forms (host
     ms and p84, device ms, idle share, tokens a round, steady tok/s,
     capture seconds apart); path b's traffic twice on one engine, captured
     (TTFT, latency and tok/s a wave, its captures); the admission
     prefill's host ms a bucket, single and grouped, in both forms (paths
     k and l print their rates, tokens a round and roofline share in
     phase 4).

``python3 chip_smoke.py --parallel`` builds the kernels and runs phase p
alone (a development mode).

``python3 chip_smoke.py --attention-timing [ROOT]`` and ``--matmul-timing
[ROOT]`` are development modes with no compatibility promise: they build
and time only kernels 2 and 3 at those shapes, or only the dequant-matmuls
and the fused SwiGLU MLP (every 7B shape in Q4_0, Q4_K and Q6_K at b 1, 2,
4, 8, 16, 128; the other formats at w_gate_up, b 1 and 16; Q8_0 at the
GPT-2 shapes, b 1, 2, 3, 4, 16, 128; the MLP at 1, 2, 8, 16, 64 rows, and
one row at E 384, F 640 and at 13B, with the unfused route beside one row;
the GELU MLP at the same rows, its unfused route beside one row; the
whole-block kernels 10 and 11, each also without its products; the
integer-dot kernel 7 in its five formats at the four 7B decode shapes;
first a digest of the b = 1 Q4_0 matvec's and kernels 10 and 11's output
bits on fixed inputs), from the package under
ROOT (default: this checkout), so that a parent checkout's kernels and
this one's are timed by one script on one card. They import whatever
package ROOT holds, and work only while ROOT's wrappers take this file's
call signatures.

Exits non-zero without a card or outside a checkout of the repository.
Prints JSON lines; the one before the card line lists the kernels; the last
is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import os
import re
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
# paths m1, m2 and n: the eval chain, KV quality and the examples
# m1 at the script's defaults but for the corpus, cut from 3000 sentences
# to 1500 (120 train chunks, ~31k held-out ids): at 3000, m1 took 69 s of
# m + n's 120 s budget, most of it the nine held-out evaluations
CHAIN_SENT, CHAIN_STEPS, CHAIN_VOCAB = 1500, 300, 512
KVQ_CHUNKS = 96         # m2: the script's default chunks (slots)
# m1's kernel route against its plain route over the same trained weights:
# fp32 differs in flash's f32 summation order alone; with activation
# rounding a one-ulp difference can move a Q8 rounding by a step (a logit by
# ~1e-2 at worst), which the mean over ~15k scored tokens shrinks
# (measured 1.0e-6 at 3000 sentences): 1e-3 relative on the perplexity
CHAIN_PPL_RTOL = 1e-3
# m2's kernel route against its plain route, decode ppl: the same rows in
# both; mm_dot "bf16" may round a softmax weight to the neighbouring bf16
# value (decode_flip_allowance): 1e-3 relative
KVQ_PPL_RTOL = 1e-3
# m2's captured steps against their eager form: the same kernels on the
# same inputs, so bit for bit is expected; the bar allows f64 summation
# of the host scoring alone (1e-6 relative)
KVQ_FORMS_RTOL = 1e-6
SERVE_EX_ARGS = ["--requests", "8", "--slots", "4"]  # n: serve_torch's runs
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


_T0 = time.perf_counter()


def log(msg):
    """A progress line, with the memory reserved on the card and the graph
    cache's size once the card is in use, and the seconds since the script
    started."""
    torch = sys.modules.get("torch")
    cap = sys.modules.get("ggmlsharp_tpu_torch.models.captured")
    if torch is not None and torch.cuda.is_initialized():
        msg += f" | reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB"
        if cap is not None:
            info = cap.cache_info()
            msg += (f", graph cache {info['trees']} trees, "
                    f"{info['entries']} entries, "
                    f"{info['home_bytes'] / 1e9:.2f} GB of home caches")
    print(f"{msg} [t {time.perf_counter() - _T0:.0f} s]", flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps, warmup=3):
    """Mean device ms a call of fn(i), i = 0..reps-1 (i picks the caller's
    input copy): the reps calls captured into one CUDA graph, its replay
    timed with CUDA events (the package's probes.common.time_ms)."""
    from ggmlsharp_tpu_torch.probes.common import time_ms as graph_time_ms

    return graph_time_ms(fn, reps, warmup)


@contextlib.contextmanager
def mm_dot(mode):
    """The port's mm_dot set to ``mode`` for the block, then restored."""
    from ggmlsharp_tpu_torch.kernels import config as kcfg

    prev = kcfg.mm_dot_mode()
    kcfg.set_mm_dot(mode)
    try:
        yield
    finally:
        kcfg.set_mm_dot(prev)


TWINS: list = []  # phase 4: each greedy generate beside its eager twin
GRAPH_CACHE_CALLS = 4  # phase 4 a2: generate calls with fresh caches


def clone_cache(cache):
    """A copy of every buffer of a KV cache."""
    from ggmlsharp_tpu_torch.models import kv_cache as kvc

    def cp(bufs):
        return None if bufs is None else [x.clone() for x in bufs]

    return kvc.KVCache(cp(cache.k), cp(cache.v), cp(cache.k_scale),
                       cp(cache.v_scale), cache.length.clone())


@contextlib.contextmanager
def eager_twins():
    """sampling.generate wrapped for the paths run inside: each greedy call
    on the card first runs in the eager form (captured.disabled(), on a
    copy of its cache; its launches taken out of the counters again), then
    as called, through the captured step. The two must give the same
    tokens bit for bit and the same launches kernel by kernel (the captured
    ones through the replay accounting); each pair is kept in TWINS with
    the captures, replays and capture seconds of the captured call. The
    peak-memory statistics are reset between the two, so a caller's peak
    is the captured call's."""
    import torch

    from ggmlsharp_tpu_torch.kernels import _build
    from ggmlsharp_tpu_torch.models import captured, sampling

    orig = sampling.generate

    def twin(forward, cfg, params, prompt, cache, n_tokens, *args, **kw):
        temperature = args[0] if args else kw.get("temperature", 0.0)
        if captured.is_disabled() or not prompt.is_cuda or temperature > 0:
            return orig(forward, cfg, params, prompt, cache, n_tokens, *args,
                        **kw)
        c0 = _build.launch_counts()
        with captured.disabled():
            eager, _ = orig(forward, cfg, params, prompt, clone_cache(cache),
                            n_tokens, *args, **kw)
        c1 = _build.launch_counts()
        _build.set_launch_counts(c0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = dict(captured.COUNTS)
        toks, out = orig(forward, cfg, params, prompt, cache, n_tokens, *args,
                         **kw)
        c2 = _build.launch_counts()
        got, want = _build.launch_delta(c0, c2), _build.launch_delta(c0, c1)
        rec = {"n_tokens": n_tokens, "tokens_equal": bool(torch.equal(
                   toks, eager)),
               "launches_equal": got == want,
               **{k: captured.COUNTS[k] - k0[k] for k in k0}}
        TWINS.append(rec)
        if not (rec["tokens_equal"] and rec["launches_equal"]):
            raise SystemExit(f"a captured generate differs from its eager "
                             f"twin: tokens {toks.tolist()} vs "
                             f"{eager.tolist()}, launches {got[0]} vs "
                             f"{want[0]}")
        return toks, out

    twin.orig = orig  # the unwrapped generate
    sampling.generate = twin
    try:
        yield
    finally:
        sampling.generate = orig


def captured_checks(dev):
    """A step with a host sync must not capture: CapturedStep raises, naming
    the CUDA error, and never returns an eager result; a per-stream buffer
    made inside a capture raises too (kernels/_sync.py); the card works
    after both."""
    import torch

    from ggmlsharp_tpu_torch.kernels import _sync
    from ggmlsharp_tpu_torch.models import captured

    calls = []

    def synced(x):
        calls.append(1)
        return x * float(x.sum())  # a host read inside the step

    x = torch.ones(4, device=dev)
    res = {}
    try:
        captured.CapturedStep(synced)(x)
        res["host_sync"] = "captured"
    except RuntimeError as e:
        res["host_sync"] = str(e)[:200]
    side = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    res["sync_buffer_refused"] = False
    try:
        with torch.cuda.graph(graph, stream=side):
            _sync.sync_buffer(dev, side.cuda_stream)
    except RuntimeError as e:
        res["sync_buffer_refused"] = "inside a CUDA graph capture" in str(e)
        res["sync_buffer"] = str(e)[:200]
    res["card_after"] = float((x * 2).sum())
    res["calls"] = len(calls)  # the warm-up and the capture, no eager run
    emit({"captured_checks": res})
    if not ("could not be captured" in res["host_sync"]
            and res["sync_buffer_refused"]
            and res["card_after"] == 8.0 and res["calls"] == 2):
        raise SystemExit(f"captured checks failed: {res}")
    return res


def flash_bound_ms(B, Hq, Hkv, S, D, npast, kv_itemsize):
    """Bytes of q, out and the K/V rows causality keeps; f32 FMAs of the
    kept scores. npast: list of ints, one a batch entry."""
    kv_rows = sum(n + S for n in npast)
    bytes_ = 2 * B * Hq * S * D * 4 + 2 * Hkv * kv_rows * D * kv_itemsize
    pairs = sum(S * n + S * (S + 1) // 2 for n in npast)  # (query, key) kept
    flops = 4 * Hq * pairs * D
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


CHECK_B = (1, 2, 5, 8, 16, 128)  # both instances; 5 and 128: ragged tiles
MMA_B = (2, 5, 8, 16, 128)       # the rows that take the multi-row instance
RAGGED = ("ragged", 4099, 11008, 0)  # N a multiple of no tile, K 43 superblocks
SHORT_K = ("short_k", 4099, 4128, 0)  # legacy formats: K % 256 = 32, a short last chunk
SHORT_KQ = ("short_k", 4099, 768, 0)  # k-quants: 3 superblocks, 24 of a b = 1 step's 32 units
LONG_K = ("long_k", 300, 106496, 0)  # b = 1: x past a CTA's shared memory, three chunks


def hold_rows(w, wabs, x, qa, mode):
    """mul_mat_q_fused (the kernel for a CUDA tensor) against the plain
    mul_mat_q on one weight and one x, Q8 activations (qa) or f32 x in
    ``mode``: (max abs err, max err over sum_k |x_k| (|q d| + |m|)_nk, ok at
    1e-5 of that sum), x as the call rounds it."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused
    from ggmlsharp_tpu_torch.ops import mul_mat_q, quantize_activations
    from ggmlsharp_tpu_torch.ops.matmul import round_bf16
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    got = mul_mat_q_fused(w, x, quantize_acts=qa, mode=mode)
    want = mul_mat_q(w, x, quantize_acts=qa, mode=mode)
    xq = dequantize(quantize_activations(x, w.gtype)) if qa \
        else (round_bf16(x) if mode == "bf16" else x)
    scale = xq.abs() @ wabs.T
    err = (got - want).abs()
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(got).all()) and bool((err <= 1e-5 * scale).all())
    return float(err.max()), float((err / scale).max()), ok


def check_weight_rows(dev, gen, fmt, tag):
    """The dequant-matmul of weight format ``fmt`` (through
    mul_mat_q_fused, which picks the instance for b) vs the plain
    mul_mat_q at every 7B shape and the ragged 4099 x 11008, b in CHECK_B,
    with the Q8 activation round trip but at the LM head; also at a short
    K, f32 and Q8 x: SHORT_K for the legacy formats (K not a multiple of the
    multi-row instance's 256-column chunk), SHORT_KQ for the k-quants (a
    b = 1 step short of a warp's 32 units); at b = 1 also at LONG_K (the
    b = 1 instance takes x in three chunks), f32 and Q8 x; f32 x in both
    mm_dot modes, each against the plain version of the same mode. Tolerance: the two sum f32
    terms in different orders, with the min terms folded through per-block
    activation sums: 1e-5 of sum_k |x_k| (|q d| + |m|)_nk, x as the call
    rounds it (2^-24 is 6e-8 a rounding). Returns the largest error; raises
    on a disagreement."""
    import torch

    worst, rows = 0.0, []
    shapes = [*Q4_SHAPES, RAGGED]
    # the k-quants need K % 256 == 0
    shapes.append(SHORT_KQ if fmt in ("Q4_K", "Q6_K") else SHORT_K)
    shapes.append(LONG_K)
    for name, n, k, _ in shapes:
        w = random_weight(fmt, n, k, gen, dev)
        wabs = weight_abs_terms(w)
        # the LM head skips the Q8 round trip; f32 x in both modes
        acts = [(qa, mode) for qa in ((False, True) if name in ("short_k",
                                                                "long_k")
                                      else (name != "output",))
                for mode in (("f32",) if qa else ("f32", "bf16"))]
        for b in (1,) if name == "long_k" else CHECK_B:
            x = torch.randn((b, k), generator=gen, device=dev)
            for qa, mode in acts:
                e, over, ok = hold_rows(w, wabs, x, qa, mode)
                worst = max(worst, e)
                rows.append({"format": fmt, "shape": name, "b": b, "n": n,
                             "k": k, "acts": "q8" if qa else "f32",
                             "mm_dot": mode, "max_abs_err": e,
                             "max_err_over_sum_abs": over, "ok": ok})
                if not ok:
                    emit({tag: rows})
                    raise SystemExit(f"{fmt} dequant-matmul disagrees: "
                                     f"{rows[-1]}")
        del w, wabs
    emit({tag: rows})
    return worst


def rows_independent_of_b(dev, gen, fmt, shapes=((4096, 4096), RAGGED[1:3]),
                          bs=MMA_B):
    """Whether a row's result is bit for bit the same at every b of ``bs``
    (the rows that take the multi-row instance: each against the last), for
    f32 x in both mm_dot modes and for Q8 activations (mma_q8_matmul), at
    each (n, k) of
    ``shapes`` (default 4096 x 4096, K split 16 ways, and the ragged 4099 x
    11008); and whether b = 1, the other instance (another order of sums by
    design), agrees with it within check_weight_rows' bar."""
    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels.matmul_q import (mma_q8_matmul,
                                                      mul_mat_q_fused)
    from ggmlsharp_tpu_torch.ops import quantize_activations
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    res = {}
    for n, k in shapes:
        w = random_weight(fmt, n, k, gen, dev)
        wabs = weight_abs_terms(w).T
        x = torch.randn((bs[-1], k), generator=gen, device=dev)
        for acts in ("f32", "bf16", "q8"):
            if acts != "q8":
                call = lambda xs, m=acts: mul_mat_q_fused(
                    w, xs, quantize_acts=False, mode=m)
                xr = x
            else:
                call = lambda xs: mma_q8_matmul(
                    w, quantize_activations(xs, GType[fmt]))
                xr = dequantize(quantize_activations(x, GType[fmt]))
            y = call(x)
            same = all(torch.equal(y[:b], call(x[:b].contiguous()))
                       for b in bs[:-1])
            # b = 1: the other instance (Q8: the dequantized round trip)
            one = mul_mat_q_fused(w, x[:1], quantize_acts=True) \
                if acts == "q8" else call(x[:1].contiguous())
            err = (one - y[:1]).abs()
            res[f"{n}x{k} {acts}"] = {
                "mma_rows_bit_equal": same,
                "b1_vs_mma_err_over_sum_abs":
                    float((err / (xr[:1].abs() @ wabs)).max())}
    res["ok"] = all(r["mma_rows_bit_equal"]
                    and r["b1_vs_mma_err_over_sum_abs"] <= 1e-5
                    for r in res.values())
    return res


def check_q4_0(dev, gen):
    """matmul_q4_0.cu's two instances vs plain (check_weight_rows)."""
    return check_weight_rows(dev, gen, "Q4_0", "q4_0_check")


def q4_rows_independent_of_b(dev, gen):
    """rows_independent_of_b for Q4_0, printed; True if it holds."""
    res = rows_independent_of_b(dev, gen, "Q4_0")
    emit({"q4_0_rows_vs_b": res})
    return res["ok"]


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
    # path m1 (D 32): the training forward over every chunk of the train
    # third, and a perplexity window's prefill (127 rows)
    ("chain_train_d32", 240, 6, 6, 128, 128, 128, 32, [0] * 240, "f32"),
    ("chain_ppl_prefill_d32", 1, 6, 6, 127, 127, 127, 32, [0], "f32"),
]


# ragged edges of kernel 2: S not a multiple of 16 or 64, T not a multiple
# of the 64-key tile, npast past the prefix view, GQA with n_rep 3 and 4, an
# f16 cache under an f32 q
FLASH_RAGGED = [
    ("ragged_gqa4_s37_t203", 2, 8, 2, 37, 203, 256, 128, [166, 400], "bf16"),
    ("ragged_f32_s70_t90", 1, 4, 4, 70, 90, 96, 64, [20], "f32"),
    ("ragged_f16_gqa3_s5_t33_d32", 3, 6, 2, 5, 33, 40, 32, [28, 0, 31],
     "f16"),
    ("ragged_f16_s130_t200_d128", 1, 2, 2, 130, 200, 208, 128, [70], "f16"),
]
_KV_DT = {"bf16": "bfloat16", "f32": "float32", "f16": "float16"}


def check_flash(dev, gen, cases=FLASH_CASES, tag="flash_check"):
    """Kernel vs plain _cached_ref: rtol 2e-4 / atol 2e-5 (online vs dense
    softmax, f32 summation order; the JAX package's kernel test bar). q is
    f32; the cache bf16, f32 or f16."""
    import torch

    from ggmlsharp_tpu_torch.kernels.flash import _cached_ref, flash_attention_cached

    worst, rows = 0.0, []
    for label, B, Hq, Hkv, S, T, Ta, D, npast, kvd in cases:
        dt = getattr(torch, _KV_DT[kvd])
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
            emit({tag: rows})
            raise SystemExit(f"flash kernel disagrees in case {label}")
    emit({tag: rows})
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
    # path m2's step: D 32, E_kv 192 (6 heads), 96 slots, T 128
    ("m2_int8_d32_T128", 96, 6, 6, 128, [(7 * i) % 129 for i in range(96)],
     "int8"),
    ("m2_bf16_d32_T128", 96, 6, 6, 128, [(7 * i) % 129 for i in range(96)],
     "bf16"),
    # D = 256 (GPT-J's head dim), GQA n_rep 2
    ("gqa2_bf16_d256_T300", 2, 8, 4, 300, [299, 40], "bf16"),
    ("gqa2_int8_d256_T300", 2, 8, 4, 300, [150, 299], "int8"),
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


# ragged edges of kernel 3: T not a multiple of the split's rows, npast past
# the prefix view, n_rep 3 and 8 (query passes of 4), n_rep 32 over 64 splits
ATTN_RAGGED = [
    ("ragged_int8_T1000", 3, 32, 32, 1000, [999, 1003, 517], "int8"),
    ("ragged_bf16_d64_nrep8_T777", 2, 16, 2, 777, [776, 900], "bf16"),
    ("ragged_int8_d64_nrep3_T130", 2, 6, 2, 130, [129, 64], "int8"),
    ("ragged_mqa_int8_nrep32_T4100", 1, 32, 1, 4100, [4100], "int8"),
    # n_rep past the old cap of 32; D 32 and D 256 at ragged T
    ("ragged_mqa_bf16_d32_nrep40_T150", 1, 40, 1, 150, [149], "bf16"),
    ("ragged_int8_d256_nrep3_T333", 2, 6, 2, 333, [332, 100], "int8"),
]


def decode_splits_on(dev, B, Hkv, T):
    """The splits the kernel's wrapper gives a launch on this card."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import decode_splits

    return decode_splits(B * Hkv, T,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count)


def decode_flip_allowance(q, kn, kc, vc, sc, np_t, Hkv, D):
    """2^-6 * max_t p_t * max_t |v_t| for each (slot, query head): what one
    or two bf16 ulps of a cache row's rounded softmax weight can move an
    output in mm_dot "bf16", where a weight on a rounding boundary may
    round either way in the kernel and in the plain version (their scores
    differ in f32 summation order). p: the f32 softmax weights of the cache
    rows, v: their values."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import _dequant

    B, Hq, _ = q.shape
    T, n_rep = kc.shape[1], Hq // Hkv
    k = _dequant(kc, sc.get("k_scale"), Hkv).reshape(B, T, Hkv, D)
    v = _dequant(vc, sc.get("v_scale"), Hkv).reshape(B, T, Hkv, D)
    qg = q.float().reshape(B, Hkv, n_rep, D) * (1.0 / D ** 0.5)
    s = torch.einsum("bgrd,btgd->bgrt", qg, k)
    live = torch.arange(T, device=q.device)[None] < np_t.long()[:, None]
    s = torch.where(live[:, None, None], s, torch.full_like(s, -1e30))
    s_new = (qg * kn.float().reshape(B, Hkv, 1, D)).sum(-1, keepdim=True)
    p = torch.softmax(torch.cat([s, s_new], -1), -1)[..., :T]
    vmax = v.abs().amax(-1).amax(1)  # [B, Hkv]
    return (2.0 ** -6 * p.amax(-1) * vmax[..., None]).reshape(B, Hq, 1)


# kernel 3's "bf16" error over its control (check_attn_decode) must stay
# under this: a kernel that computed the "f32" function in "bf16" reads 1;
# sound runs read 1e-4 to 0.107 on an H100, the largest where a rounded
# softmax weight on a boundary flips (PERF.md §6, PR 11)
MODE_SEP = 0.5


def check_attn_decode(dev, gen, cases=ATTN_CASES, tag="attn_decode_check"):
    """Kernel vs its plain versions in each mm_dot mode. "f32": the dense
    _decode_ref and the split algorithm _decode_ref_split at the kernel's
    splits, rtol 2e-4 / atol 2e-5 (all f32; online vs dense softmax and
    summation order). "bf16": the dense _decode_ref of that mode, at the
    same bar plus decode_flip_allowance (a rounded softmax weight on a
    rounding boundary). That allowance is ~20x the gap between the two
    functions, so "bf16" is also held against a control, the kernel's
    "f32" output against the "bf16" plain version: its largest error must
    stay under MODE_SEP times the control's."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import (_decode_ref,
                                                         _decode_ref_split,
                                                         flash_decode_flat)

    worst, rows = 0.0, []
    for label, B, Hq, Hkv, T, npast, kind in cases:
        d = re.search(r"_d(\d+)_", label)
        D = int(d.group(1)) if d else 128
        q, kn, vn, ((kc, vc, sc),) = decode_inputs(dev, gen, B, Hq, Hkv, T,
                                                   kind, D=D)
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
        splits = decode_splits_on(dev, B, Hkv, T)
        args = (q, kn, vn, kc, vc, np_t, Hkv, D)
        flips = decode_flip_allowance(q, kn, kc, vc, sc, np_t, Hkv, D)
        row = {"case": label, "splits": splits, "ok": True}
        outs = {}
        for mode, name, want, extra in (
                ("f32", "dense", _decode_ref(*args, **sc), 0.0),
                ("f32", "split", _decode_ref_split(*args, **sc,
                                                   splits=splits), 0.0),
                ("bf16", "dense_bf16", _decode_ref(*args, **sc, mode="bf16"),
                 flips)):
            got = flash_decode_flat(*args, **sc, mode=mode)
            torch.cuda.synchronize()
            err = (got - want).abs()
            row["ok"] &= bool(torch.isfinite(got).all()) and bool(
                (err <= 2e-5 + 2e-4 * want.abs() + extra).all())
            row[f"max_abs_err_{name}"] = float(err.max())
            worst = max(worst, float(err.max()))
            outs[name] = got, want
        want_bf16 = outs["dense_bf16"][1]
        control = float((outs["dense"][0] - want_bf16).abs().max())
        row["control_f32_vs_plain_bf16"] = control
        row["bf16_over_control"] = (row["max_abs_err_dense_bf16"]
                                    / max(control, 1e-30))
        row["ok"] &= row["bf16_over_control"] <= MODE_SEP
        rows.append(row)
        if not row["ok"]:
            emit({tag: rows})
            raise SystemExit(f"attn_decode kernel disagrees in case {label}")
    emit({tag: rows})
    return worst


def dq_launches(kern, multi, single):
    """Expected launches of a source with two instances (the dequant-matmuls,
    kernel 9): ``multi`` of its multi-row instance (counter ``<kern>_mma``,
    b >= MMA_MIN_ROWS) and ``single`` of its b = 1 instance."""
    return {f"{kern}_mma": multi, kern: single}


def llama_b1_launches(cfg):
    """Expected launches of path a's generate (a 16-token prompt and N_NEW
    tokens over the bf16 head-major cache)."""
    from ggmlsharp_tpu_torch import kernels

    n = 4 * cfg.n_layer + 1
    return dict.fromkeys(kernels.LAUNCHES, 0) | {
        # 4 a block + LM head: the prompt's at 16 rows, each token's at 1
        **dq_launches("matmul_q4_0", n, n * N_NEW),
        "flash_attn": cfg.n_layer}         # one a layer, prefill only
    # attn_decode 0: a head-major cache decodes through einsum


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
    want = llama_b1_launches(cfg)
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


def release_graphs():
    """What a user does on dropping a model: the graph cache cleared (its
    entries hold their trees, home caches and graphs), the freed memory
    returned to the card."""
    import torch

    from ggmlsharp_tpu_torch.models import captured

    captured.clear()
    torch.cuda.empty_cache()


def same_rows(a, b):
    """Whether two KV caches hold the same lengths and, below the longest,
    the same rows of every buffer, bit for bit."""
    import torch

    from ggmlsharp_tpu_torch.models import captured

    n = int(a.length.max())
    dim = 1 if a.is_flat else 2
    return torch.equal(a.length, b.length) and all(
        torch.equal(x.narrow(dim, 0, n), y.narrow(dim, 0, n))
        for x, y in zip(captured.buffers(a)[1:], captured.buffers(b)[1:]))


def graph_cache_phase(smi, cfg, params, prompt, toks_a, reps=5):
    """Phase 4 a2: the graph cache on path a (Llama-7B Q4_0, b = 1, 16 +
    N_NEW, bf16 head-major cache). From an empty graph cache, generate
    GRAPH_CACHE_CALLS times with a fresh cache each: calls 2-4 must make no
    capture, every call must give the eager form's tokens (path a's),
    launches and live cache rows, bit for bit, and the memory reserved
    after calls 3 and 4 must equal call 2's. Then the prefill's ms in both
    forms (a synced call's median of ``reps``, the cache's length reset
    between calls), and two calls on two caches with different prompts:
    each cache must hold its own prompt's rows (the eager prefill's)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured, llama, sampling

    gen = getattr(sampling.generate, "orig", sampling.generate)  # no twin
    T = cfg.n_ctx

    def call(pr, eager=False):
        cache = llama.new_cache(cfg, 1)
        torch.cuda.synchronize()
        kernels.reset_launches()
        k0 = dict(captured.COUNTS)
        t0 = time.perf_counter()
        with captured.disabled() if eager else contextlib.nullcontext():
            toks, out = gen(llama.forward, cfg, params, pr, cache, N_NEW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return toks, out, dict(kernels.LAUNCHES), \
            {k: captured.COUNTS[k] - k0[k] for k in k0}, secs

    release_graphs()  # from an empty graph cache
    e_toks, e_cache, e_launches, _, e_secs = call(prompt, eager=True)
    calls = []
    for i in range(GRAPH_CACHE_CALLS):
        toks, cache, launches, counts, secs = call(prompt)
        calls.append({"host_s": secs, **counts,
                      "tokens_equal_eager": bool(torch.equal(toks, e_toks)),
                      "launches_equal_eager": launches == e_launches,
                      "rows_equal_eager": same_rows(cache, e_cache),
                      "reserved_gb": torch.cuda.memory_reserved() / 1e9})
        del cache
    res = {"card": smi, "calls": calls, "eager_host_s": e_secs,
           "tokens_equal_path_a": bool(torch.equal(e_toks, toks_a)),
           "cache_info": captured.cache_info()}

    prefill, _ = sampling.make_decode_fns(llama.forward, cfg)
    t_eff = sampling.length_bucket(PROMPT_LEN, T)
    for form in ("eager", "captured"):
        cache = llama.new_cache(cfg, 1)
        ms = []
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            for _ in range(reps):
                cache.length.zero_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(params, prompt, cache, t_eff=t_eff)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        res[f"prefill_ms_{form}"] = statistics.median(ms)
        res[f"prefill_ms_{form}_all"] = ms
        del cache

    # two caches of one spec, two prompts, one call after the other: each
    # returned cache holds its own prompt's rows (home and caller apart)
    g = torch.Generator(prompt.device).manual_seed(SEED + 22)
    prompt_b = torch.randint(0, cfg.n_vocab, prompt.shape, generator=g,
                             device=prompt.device, dtype=prompt.dtype)
    ca, cb = llama.new_cache(cfg, 1), llama.new_cache(cfg, 1)
    gen(llama.forward, cfg, params, prompt, ca, N_NEW)
    gen(llama.forward, cfg, params, prompt_b, cb, N_NEW)
    with captured.disabled():
        eb = llama.new_cache(cfg, 1)
        prefill(params, prompt_b, eb, t_eff=t_eff)
    rows = slice(0, PROMPT_LEN)
    res["no_alias"] = {
        "a_rows_equal_eager": same_rows(ca, e_cache),
        "b_prompt_rows_equal_eager": all(
            torch.equal(x[:, :, rows], y[:, :, rows])
            for x, y in zip((*cb.k, *cb.v), (*eb.k, *eb.v))),
        "a_b_prompt_rows_differ": not torch.equal(ca.k[0][:, :, rows],
                                                  cb.k[0][:, :, rows])}
    del ca, cb, eb, e_cache
    emit({"graph_cache": res})
    again_mem = calls[1]["reserved_gb"]  # no creep over repeated calls
    if not (all(c["tokens_equal_eager"] and c["launches_equal_eager"]
                and c["rows_equal_eager"] for c in calls)
            and res["tokens_equal_path_a"]
            and calls[0]["captures"] > 0
            and all(c["captures"] == 0 for c in calls[1:])
            and all(c["reserved_gb"] == again_mem for c in calls[2:])
            and all(res["no_alias"].values())):
        raise SystemExit(f"graph cache on path a failed: {res}")
    return res


# phase 4 a3: t_eff=None through the in-graph bucket switch
SWITCH_LEN = 1024  # a3's caches: buckets 256, 512 and 1024
SWITCH_PROMPT = 240  # a3's prompt: the steps cross 256 and 512
SWITCH_STEPS = 300
SWITCH_ROUND_TO = 520  # a3's k1 rounds run until the target passes this
SWITCH_PROFILE_AT = 100  # a3's profiler window: lims 341.. (bucket 512)
SWITCH_PROFILE_STEPS = 20


def check_graph_switch(dev, gen):
    """The selector kernel (csrc/graph_switch.cu, run alone through
    graph_switch_select) against its plain version (graph_switch.
    select_index) on random lengths of 1-96 slots, for a decode step, a
    prefill and a round's two caches at T 1024 and 2048; each index as
    JAX's formula gives it. Returns (max abs index error, the row's
    timings)."""
    import torch

    from ggmlsharp_tpu_torch.kernels import graph_switch as gs
    from ggmlsharp_tpu_torch.models.common import _chunk_buckets

    err = 0
    cases = 0
    for T in (1024, 2048):
        for B in (1, 8, 96):
            for add in (1, SPEC_K + 1, 240):
                ln = torch.randint(0, T - add + 1, (B,), generator=gen,
                                   device=dev, dtype=torch.int32)
                dl = torch.randint(0, T - add + 1, (B,), generator=gen,
                                   device=dev, dtype=torch.int32)
                one = (gs.bucket_bound("t_eff", ln, add, _chunk_buckets(T)),)
                two = one + (gs.bucket_bound("d_eff", dl, add,
                                             _chunk_buckets(T)),)
                for bounds in (one, two):
                    got = int(gs.select(bounds))
                    want = int(gs.select_index(bounds))
                    err = max(err, abs(got - want))
                    cases += 1
    if err:
        raise SystemExit(f"graph_switch: the selector's index differs from "
                         f"its plain version by {err}")
    # timing at a3's step (one slot, T 1024) and path b's engine (8 slots)
    ln = torch.randint(0, 700, (8,), generator=gen, device=dev,
                       dtype=torch.int32)
    bounds = (gs.bucket_bound("t_eff", ln, 1, _chunk_buckets(SWITCH_LEN)),)
    reps = 200
    ms = time_ms(lambda i: gs.select(bounds), reps)
    plain_ms = time_ms(lambda i: gs.select_index(bounds), reps)
    # the least work: the lengths read once, the index written once
    bound_ms = (ln.numel() * 4 + 4) / HBM_BYTES_S * 1e3
    return err, {"cases": cases, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": None, "design": gs.design()}


def run_switch_phase(smi, cfg, params, dev, gen):
    """Phase 4 a3: make_decode_fns' prefill and step, and make_greedy_step,
    at t_eff=None over a 1024-row cache at Llama-7B Q4_0 full width (path
    a's tree): a SWITCH_PROMPT-token prompt, then SWITCH_STEPS greedy
    steps (lims 241..540: buckets 256, 512 and 1024). The switched step
    captures once and replays one parent graph for the whole run, under
    torch.cuda.set_sync_debug_mode("error") (no host sync); its tokens
    and launches (the selector's aside) equal the t_eff-passing form's,
    whose graphs are one a bucket. The switched step is run again with
    the older toolkits' parent (a chain of if nodes, -DGS_SWITCH=0): the
    switch node's tokens and launches. Then one k1 speculative call
    (draft = target, k = SPEC_K) round by round at t_eff = d_eff = None
    against the t_eff-passing rounds, until the target passes
    SWITCH_ROUND_TO. Host ms a step (a round) and tok/s of both forms.
    Last, after every timed run (a profiler leaves the host slower for
    the rest of the process), each form's step under a torch.profiler
    window of SWITCH_PROFILE_STEPS steps from one length: device ms and
    kernels a step, and the idle share against the same window's untraced
    ms a step. Returns (record, the switched runs' launches)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.kernels import _build
    from ggmlsharp_tpu_torch.kernels import graph_switch as gs
    from ggmlsharp_tpu_torch.models import captured, llama, sampling
    from ggmlsharp_tpu_torch.models.speculative import make_spec_round

    T = SWITCH_LEN
    prompt = torch.randint(0, cfg.n_vocab, (1, SWITCH_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    res = {"card": smi, "design": gs.design(), "max_len": T,
           "prompt": SWITCH_PROMPT, "steps": SWITCH_STEPS}

    def decode(form, greedy=False):
        """Two passes of SWITCH_STEPS steps from the prefill: the first
        captures (its launches and captured.COUNTS recorded), the second,
        from the same cache rows and length, replays only and is timed
        (the switched one under the sync check; the host's ms a step to
        issue it beside the ms a step to its end); then the untraced
        window of SWITCH_PROFILE_STEPS steps from length SWITCH_PROMPT +
        SWITCH_PROFILE_AT. Returns the tokens of both passes, the record
        and trace(), which profiles the same window."""
        switched = form == "switched"
        prefill, step = sampling.make_decode_fns(llama.forward, cfg)
        if greedy:
            step = sampling.make_greedy_step(llama.forward, cfg)
        cache = llama.new_cache(cfg, 1, max_len=T)
        outs = [torch.empty((1, SWITCH_STEPS), dtype=torch.int32,
                            device=dev) for _ in range(2)]

        def run(out):
            tok = tok0
            for i in range(SWITCH_STEPS):
                t_eff = None if switched else sampling.length_bucket(
                    SWITCH_PROMPT + i + 1, T)
                y, _ = step(params, tok, cache, t_eff=t_eff)
                tok = y if greedy else torch.argmax(
                    y, -1, keepdim=True).to(torch.int32)
                out[:, i:i + 1] = tok

        with torch.inference_mode():
            lg, cache = prefill(params, prompt, cache, t_eff=None if switched
                                else sampling.length_bucket(SWITCH_PROMPT, T))
            tok0 = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            k0 = dict(captured.COUNTS)
            c0 = _build.launch_counts()
            run(outs[0])  # the captures
            torch.cuda.synchronize()
            launches = _build.launch_delta(c0, _build.launch_counts())[0]
            rec = {"launches": launches, "final_length": int(cache.length[0]),
                   **{k: captured.COUNTS[k] - k0[k] for k in k0}}
            cache.length.fill_(SWITCH_PROMPT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if switched:
                torch.cuda.set_sync_debug_mode("error")
            try:
                run(outs[1])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            issued = time.perf_counter() - t0
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            at = {}

            def window():
                """SWITCH_PROFILE_STEPS steps ready to run from one length
                (the same for both forms)."""
                at.update(i=SWITCH_PROFILE_AT, tok=tok0)
                cache.length.fill_(SWITCH_PROMPT + SWITCH_PROFILE_AT)
                torch.cuda.synchronize()

            def one_step():
                i = at["i"]
                t_eff = None if switched else sampling.length_bucket(
                    SWITCH_PROMPT + i + 1, T)
                y, _ = step(params, at["tok"], cache, t_eff=t_eff)
                at["tok"] = y if greedy else torch.argmax(
                    y, -1, keepdim=True).to(torch.int32)
                at["i"] = i + 1

            window()  # untraced: the window's ms a step
            w0 = time.perf_counter()
            for _ in range(SWITCH_PROFILE_STEPS):
                one_step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - w0) * 1e3 / SWITCH_PROFILE_STEPS

        def trace():
            """The window again under the profiler, into the record."""
            with torch.inference_mode():
                window()
                prof = profile_steps(one_step, SWITCH_PROFILE_STEPS)
            dev_ms = prof["device_ms_per_step"]
            rec.update(profile=prof, device_idle_share=(
                1.0 - dev_ms / window_ms if isinstance(dev_ms, float)
                else "not measured"))

        rec.update(host_ms_per_step=secs * 1e3 / SWITCH_STEPS,
                   tok_s=SWITCH_STEPS / secs,
                   issue_ms_per_step=issued * 1e3 / SWITCH_STEPS,
                   window_ms_per_step=window_ms,
                   passes_equal=bool(torch.equal(outs[0], outs[1])))
        return outs[0], rec, trace

    btoks, brec, btrace = decode("bucketed")
    stoks, srec, strace = decode("switched")
    gtoks, grec, _ = decode("switched", greedy=True)
    sel = srec["launches"].pop("graph_switch", 0)
    gsel = grec["launches"].pop("graph_switch", 0)
    res.update(bucketed=brec, switched=srec, greedy=grec,
               tokens_equal=bool(torch.equal(btoks, stoks)),
               greedy_tokens_equal=bool(torch.equal(gtoks, stoks)),
               launches_equal=brec["launches"] == srec["launches"]
               == grec["launches"],
               selector_launches=sel + gsel,
               lims=[SWITCH_PROMPT + 1, SWITCH_PROMPT + SWITCH_STEPS])
    srec["launches"]["graph_switch"] = sel
    if not (res["tokens_equal"] and res["greedy_tokens_equal"]
            and res["launches_equal"] and sel == gsel == SWITCH_STEPS
            and all(r["passes_equal"] for r in (brec, srec, grec))):
        raise SystemExit(f"a3: the switched step differs from the "
                         f"t_eff-passing form: {res}")
    if not (srec["captures"] == grec["captures"] == 1
            and srec["switch_bodies"] == grec["switch_bodies"] == 3
            and srec["replays"] == SWITCH_STEPS
            and brec["captures"] == 3):
        raise SystemExit(f"a3: captures {srec}, {grec}, {brec}")
    gs.set_design("if_chain")  # the older toolkits' parent, built here
    try:
        ctoks, crec, _ = decode("switched")
        cdesign = gs.design()
    finally:
        gs.set_design()
    res["if_chain"] = {
        "design": cdesign, "captures": crec["captures"],
        "switch_bodies": crec["switch_bodies"],
        "host_ms_per_step": crec["host_ms_per_step"],
        "window_ms_per_step": crec["window_ms_per_step"],
        "tokens_equal": bool(torch.equal(ctoks, stoks)),
        # the selector's launches included, one a step in both
        "launches_equal": crec["launches"] == srec["launches"]}
    if not (cdesign == "if_chain" and res["if_chain"]["tokens_equal"]
            and res["if_chain"]["launches_equal"] and crec["passes_equal"]
            and crec["captures"] == 1 and crec["switch_bodies"] == 3):
        raise SystemExit(f"a3: the if-chain parent differs from the switch "
                         f"node's: {res['if_chain']}")

    # k1: rounds at t_eff = d_eff = None against the t_eff-passing rounds
    rnd = make_spec_round(llama.forward, cfg, llama.forward, cfg, SPEC_K)

    def rounds(form, n=None):
        """Rounds from the prefilled caches (until the target passes
        SWITCH_ROUND_TO, or n), twice: the first captures, the second, from
        the same caches' rows, lengths and seed, replays only and is timed
        (the switched one under the sync check; the t_eff-passing one reads
        each round's count back to track its bound)."""
        switched = form == "switched"
        tc = llama.new_cache(cfg, 1, max_len=T)
        dc = llama.new_cache(cfg, 1, max_len=T)
        S = SWITCH_PROMPT
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]

        def run(n):
            seed, outs, h, lims, i = seed0, [], S, [], 0
            while (h <= SWITCH_ROUND_TO) if n is None else i < n:
                # the bounds the selector picks: the target's lim h + k + 1,
                # the draft's (d_len = h - 1) h + k
                t_eff, d_eff = (None, None) if switched else (
                    sampling.length_bucket(h + SPEC_K + 1, T),
                    sampling.length_bucket(h + SPEC_K, T))
                em, ne, _, _, seed = rnd(params, params, tc, dc, seed,
                                         t_eff=t_eff, d_eff=d_eff)
                seed = seed.clone()
                outs.append(torch.cat([em, ne[:, None]], 1).clone())
                if not switched:  # the host tracks the bound
                    lims.append(h + SPEC_K + 1)
                    h += int(ne[0])
                i += 1
            return torch.cat(outs), lims, i

        with torch.inference_mode():
            lg, o = llama.forward(params, cfg, prompt, tc, pos,
                                  prefix_bound=256)
            tc.length.copy_(o.length)
            _, o = llama.forward(params, cfg, prompt[:, :-1], dc,
                                 pos[:, :-1], prefix_bound=256)
            dc.length.copy_(o.length)
            seed0 = torch.cat([prompt[:, -1:], torch.argmax(
                lg[:, -1], -1, keepdim=True).to(torch.int32)], 1)
            torch.cuda.synchronize()
            k0 = dict(captured.COUNTS)
            c0 = _build.launch_counts()
            got, lims, n = run(n)  # the captures
            torch.cuda.synchronize()
            rec = {"rounds": n, "final_length": int(tc.length[0]),
                   "lims": lims[:1] + lims[-1:],
                   "launches": _build.launch_delta(
                       c0, _build.launch_counts())[0],
                   **{k: captured.COUNTS[k] - k0[k] for k in k0}}
            tc.length.fill_(S)
            dc.length.fill_(S - 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if switched:
                torch.cuda.set_sync_debug_mode("error")
            try:
                again, _, _ = run(n)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        got = got.cpu()
        rec.update(host_ms_per_round=secs * 1e3 / n,
                   tok_s=float(got[:, -1].sum()) / secs,
                   passes_equal=bool(torch.equal(got, again.cpu())))
        return got, rec

    b_out, b_rec = rounds("bucketed")
    s_out, s_rec = rounds("switched", b_rec["rounds"])
    rsel = s_rec["launches"].pop("graph_switch", 0)
    res["k1_rounds"] = {
        "bucketed": b_rec, "switched": s_rec,
        "tokens_equal": bool(torch.equal(b_out, s_out)),
        "launches_equal": b_rec["launches"] == s_rec["launches"],
        "selector_launches": rsel}
    s_rec["launches"]["graph_switch"] = rsel
    if not (res["k1_rounds"]["tokens_equal"]
            and res["k1_rounds"]["launches_equal"]
            and b_rec["passes_equal"] and s_rec["passes_equal"]
            and rsel == b_rec["rounds"] and s_rec["captures"] == 1
            and b_rec["lims"][0] <= 256 < 512 < b_rec["lims"][-1]):
        raise SystemExit(f"a3: the switched k1 rounds differ from the "
                         f"t_eff-passing ones: {res['k1_rounds']}")
    res["capture_s"] = {"step": srec["capture_s"],
                        "round": s_rec["capture_s"]}
    btrace()  # the profiler windows, after every timed run
    strace()
    release_graphs()
    emit({"switch_a3": res})
    # the switched runs' launches: the step and the rounds
    return res, {k: srec["launches"].get(k, 0) + s_rec["launches"].get(k, 0)
                 for k in kernels.LAUNCHES}


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
    the path in the printed row; ``cache_kw`` goes to new_cache. Weight-only
    (``quant_acts`` False) runs in mm_dot "f32", where the two paths differ
    in f32 summation order alone (in "bf16" a one-ulp difference of an
    activation can move its bf16 rounding, as it can a Q8 one); with the Q8
    round trip, in the configured mode."""
    import functools

    import torch

    from ggmlsharp_tpu_torch.kernels.config import mm_dot_mode
    from ggmlsharp_tpu_torch.models import sampling

    os.environ["GGML_TPU_QUANT_ACTS"] = "1" if quant_acts else "0"
    try:
        with mm_dot(mm_dot_mode() if quant_acts else "f32"):
            if toks is None:
                toks, _ = sampling.generate(
                    model.forward, cfg, params, prompt,
                    model.new_cache(cfg, 1, dtype=cache_dtype, **cache_kw),
                    N_CMP)
            out = {}
            with torch.inference_mode():
                for plain in (False, True):
                    prefill, step = sampling.make_decode_fns(
                        functools.partial(model.forward, plain=plain), cfg)
                    cache = model.new_cache(cfg, 1, dtype=cache_dtype,
                                            **cache_kw)
                    cur = PROMPT_LEN
                    lg, cache = prefill(params, prompt, cache,
                                        t_eff=sampling.length_bucket(
                                            cur, cfg.n_ctx))
                    rows = [lg[0].float()]
                    for i in range(N_CMP - 1):
                        cur += 1
                        lg, cache = step(params, toks[:, i:i + 1], cache,
                                         t_eff=sampling.length_bucket(
                                             cur, cfg.n_ctx))
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
    """The serving path in both forms: a warm-up engine answers one admission
    wave of 2 tokens each; then for the captured form (the default: one CUDA
    graph a length bucket) and the eager form (captured.disabled()), a fresh
    engine answers the SERVE_REQS requests, with the launch counters, the
    capture counts and the peak-memory statistics reset just before its run
    and read just after. Every admission prefill here is a 16-row bucket
    (S > 8: flash), every decode forward a batched single-token step
    (attn_decode). The two forms must give the same tokens and launches.
    Returns the captured form's engine, its record (the eager form's under
    "eager") and its tokens."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.serving import Request

    prompts = serving_prompts(cfg)
    warm = new_engine(cfg, params)
    for i in range(SLOTS):
        warm.submit(Request(id=i, prompt=prompts[i], max_new_tokens=2))
    warm.run()
    del warm
    forms, engines = {}, {}
    for form in ("captured", "eager"):
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng = new_engine(cfg, params)
            for i, p in enumerate(prompts):
                eng.submit(Request(id=i, prompt=p, max_new_tokens=SERVE_NEW))
            torch.cuda.synchronize()
            kernels.reset_launches()
            captured.reset_counts()
            t0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        engines[form] = eng
        forms[form] = {
            "requests": len(results), "seconds": seconds,
            "tokens_per_s": SERVE_REQS * SERVE_NEW / seconds,
            "stats": eng.stats(), "launches": dict(kernels.LAUNCHES),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            **{k: v for k, v in captured.COUNTS.items()},
            "out": [r.out_tokens for r in results],
            "bad": [r.id for r in results
                    if r.error is not None or len(r.out_tokens) != SERVE_NEW
                    or not all(0 <= t < cfg.n_vocab for t in r.out_tokens)]}
    del engines["eager"]
    res, eager = forms["captured"], forms["eager"]
    st = res["stats"]
    n_dec, n_pre = st["decode_forwards"], st["prefill_dispatches"]
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        # every forward batches 8 slots (decode) or 8 prompts (prefill)
        **dq_launches("matmul_q4_0", (4 * cfg.n_layer + 1) * (n_dec + n_pre),
                      0),
        "flash_attn": cfg.n_layer * n_pre,
        "attn_decode": cfg.n_layer * n_dec}
    res.update(expected_launches=want,
               first_tokens=[o[:4] for o in res["out"][:3]],
               tokens_equal_eager=res["out"] == eager["out"],
               eager={k: v for k, v in eager.items() if k != "out"})
    out_toks = res.pop("out")
    emit({"serving_path": res})
    if res["launches"] != want or eager["launches"] != want or n_dec == 0:
        raise SystemExit(f"serving launch counts {res['launches']} (eager "
                         f"{eager['launches']}) != expected {want}")
    if not res["tokens_equal_eager"]:
        raise SystemExit("serving: the captured form's tokens differ from "
                         "the eager form's")
    if res["requests"] != SERVE_REQS or res["bad"] or eager["bad"]:
        raise SystemExit(f"serving answered {res['requests']} requests, bad "
                         f"{res['bad']} (eager {eager['bad']})")
    return engines["captured"], res, out_toks


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
                rows.append(eng._step(toks[j][:slots], active,
                                      t_eff)[0].clone())
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

    # batched decode steps of the kernel engine (8 live slots), in each
    # form: untraced step time and launches a step, then a profiled window
    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured

    state = {"logits": kern[-1], "j": 0}
    active = torch.ones(SLOTS, dtype=torch.bool, device=eng.device)

    def one_step():
        tok = state["logits"].argmax(-1, keepdim=True).to(torch.int32)
        state["j"] += 1
        t_eff = length_bucket(max(lens) + REPLAY_STEPS + state["j"],
                              SERVE_MAX_LEN, base=64)
        with torch.no_grad():
            state["logits"] = eng._step(tok, active, t_eff)[0]

    profs = {}
    for form in ("eager", "captured"):
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            captured.reset_counts()
            lat = []
            for i in range(12):  # 4 warm-up steps
                if i == 4:
                    kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one_step()
                torch.cuda.synchronize()
                if i >= 4:
                    lat.append(time.perf_counter() - t0)
            n_launch = sum(kernels.LAUNCHES.values()) / len(lat)
            prof = profile_steps(one_step, 2 if form == "eager" else 4)
        lat_ms = sorted(x * 1e3 for x in lat)
        prof.update(untraced_step_ms_median=statistics.median(lat_ms),
                    untraced_step_ms_p84=lat_ms[int(0.84 * len(lat_ms))],
                    window_tok_s=SLOTS * 1e3 / statistics.median(lat_ms),
                    launches_per_step=n_launch,
                    **{k: v for k, v in captured.COUNTS.items()})
        profs[form] = prof
    prof = profs["captured"]
    check_trace(prof, profs["eager"])
    for p in profs.values():
        dev_ms = p["device_ms_per_step"]
        p["device_idle_share"] = (1.0 - dev_ms / p["untraced_step_ms_median"]
                                  if isinstance(dev_ms, float)
                                  else "not measured")
    prof["eager"] = profs["eager"]
    emit({"serving_decode_profile": prof})
    return err, prof


def check_trace(prof, eager):
    """A trace of captured steps must see the kernels the graph replays
    run: at least 0.9 of the eager form's kernels a step (``eager``, its
    profile_steps over the same steps) and half its device time. Else the
    device time reads "not measured", and the eager trace's device time (the
    same kernels) is kept beside it under its own name."""
    dev, ref = prof["device_ms_per_step"], eager["device_ms_per_step"]
    seen = (prof["kernels_per_step"] >= 0.9 * eager["kernels_per_step"]
            and isinstance(dev, float) and isinstance(ref, float)
            and dev >= 0.5 * ref)
    prof["trace_sees_graph_kernels"] = seen
    prof["eager_trace_device_ms_per_step"] = ref
    prof["eager_trace_kernels_per_step"] = eager["kernels_per_step"]
    if not seen:
        prof["device_ms_per_step"] = (
            f"not measured (the trace saw {prof['kernels_per_step']:.1f} "
            f"kernels and {dev} ms a step, the eager form's "
            f"{eager['kernels_per_step']:.1f} and {ref})")


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


TIMING_B = (1, 2, 4, 8, 16, 128)  # --matmul-timing's activation rows
PHASE5_B = (1, 8, 16, 128)     # phase 5's: decode, a serving tick,
                               # a prompt, a serving prefill


def time_weight_rows(dev, gen, fmt, shapes, bs, plain=True):
    """Cold-L2 times of the dequant-matmul of weight format ``fmt``
    (matmul_q4_0.cu for Q4_0, matmul_q8_0.cu for Q8_0, else kernel A)
    through its wrappers, which pick the instance for b, at each (name, N,
    K, launches a forward) of ``shapes`` and each b of ``bs``, in two rows:
    ``acts`` "f32", x as it comes (the LM head's case), and, but at the LM
    head (``output``, ``wte``), "q8", x rounded
    through the format's Q8 activation type, the operands the path's other
    matmuls hand the kernel (the multi-row instance takes the Q8 values,
    kernels.matmul_q.mma_q8_matmul, where the package has it; else the
    wrapper takes the rounded x in f32), and, where the package's wrappers
    read mm_dot, "bf16": x as it comes in mm_dot "bf16" (one bf16 plane).
    Each row: the kernel, the library call (bf16 torch.matmul of x against
    the weight dequantized to bf16) and, with ``plain`` (True, or the b's
    to take it at), the plain version of the same mode; the bound
    (wq_bound_ms). Weights are random from the
    seed, rotated over copies past four L2 sizes."""
    import inspect

    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels import _build
    from ggmlsharp_tpu_torch.kernels import matmul_q as mq
    from ggmlsharp_tpu_torch.ops import mul_mat_q, quantize_activations
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    own = {"Q4_0": mq.q4_0_matmul, "Q8_0": mq.q8_0_matmul}.get(fmt)
    call = (lambda x, w, **kw: own(x, w["qs"], w["d"], **kw)) if own \
        else mq.q_matmul
    moded = "mode" in inspect.signature(mq.q4_0_matmul).parameters
    q8_call = getattr(mq, "mma_q8_matmul", None)
    if fmt == "Q8_0" and "matmul_q8_0_mma" not in _build.KERNELS:
        q8_call = None  # a package whose Q8_0 has no multi-row instance
    min_rows = getattr(mq, "MMA_MIN_ROWS", 2)
    rows = []
    for name, n, k, per_fwd in shapes:
        w0 = random_weight(fmt, n, k, gen, dev)
        wbytes = w0.nbytes()
        copies = max(2, -(-4 * L2_BYTES // wbytes))
        ws = [w0] + [random_weight(fmt, n, k, gen, dev)
                     for _ in range(copies - 1)]
        wb = [dequantize(w, fused_scales=True).to(torch.bfloat16)
              for w in ws]
        reps = max(50, copies)
        for b in bs:
            x = torch.randn((b, k), generator=gen, device=dev)
            for acts in (("f32",) if name in ("output", "wte")
                         else ("f32", "q8")) + (("bf16",) if moded else ()):
                x_bytes = b * k * 4  # f32 x
                if acts == "f32":
                    xr, kern = x, (lambda i: call(x, ws[i % copies]))
                elif acts == "bf16":
                    xr, kern = x, (lambda i: call(x, ws[i % copies],
                                                  mode="bf16"))
                elif q8_call is not None and b >= min_rows:
                    aq = quantize_activations(x, GType[fmt])
                    xr = dequantize(aq)
                    kern = lambda i: q8_call(ws[i % copies], aq)
                    x_bytes = aq["qs"].nbytes + aq["d"].nbytes
                else:
                    xr = dequantize(quantize_activations(x, GType[fmt]))
                    kern = lambda i: call(xr, ws[i % copies])
                xb = xr.to(torch.bfloat16)
                ms = time_ms(kern, reps)
                lib = time_ms(lambda i: torch.matmul(xb, wb[i % copies].T),
                              reps)
                bound, by = wq_bound_ms(b, n, k, wbytes, x_bytes,
                                        acts == "q8",
                                        1 if acts == "bf16" else 3)
                row = {"format": fmt, "shape": name, "b": b, "acts": acts,
                       "n": n, "k": k, "weight_bytes": wbytes, "ms": ms,
                       "library_ms": lib, "bound_ms": bound, "bound_by": by,
                       "roofline_share": bound / ms, "cold_copies": copies,
                       "launches_per_forward": per_fwd}
                if plain is True or (plain and b in plain):
                    row["plain_ms"] = time_ms(
                        lambda i: mul_mat_q(ws[i % copies], xr,
                                            quantize_acts=False,
                                            mode="bf16" if acts == "bf16"
                                            else "f32"), 8)
                rows.append(row)
        del ws, wb
        torch.cuda.empty_cache()
    return rows


def forward_sum(rows, fmt, b, acts="q8"):
    """ms, plain, library and bound of one forward's launches at b rows
    as the path runs them: each shape's time times its launches a forward,
    the row with activations ``acts`` where the shape has one (its f32 row
    otherwise: the LM head's); bound_by: what bounds the rows that take the
    larger share of the summed bound."""
    sel = [r for r in rows if r["format"] == fmt and r["b"] == b]
    sel = [r for r in sel if r["acts"] == acts or r["acts"] == "f32" and not any(
        o["shape"] == r["shape"] and o["acts"] == acts for o in sel)]
    out = {key: sum(r[key] * r["launches_per_forward"] for r in sel)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")
           if all(key in r for r in sel)}
    share = {}
    for r in sel:
        share[r["bound_by"]] = (share.get(r["bound_by"], 0.0)
                                + r["bound_ms"] * r["launches_per_forward"])
    if share:
        out["bound_by"] = max(share, key=share.get)
    return out


def time_q4_0(dev, gen, counts):
    """Phase 5 of matmul_q4_0.cu at every 7B shape, b in PHASE5_B: the
    kernels-line rows of its b = 1 instance (one decode token: 129
    launches) and its multi-row instance (one prompt forward of path a:
    129 launches at b = 16)."""
    rows = time_weight_rows(dev, gen, "Q4_0", Q4_SHAPES, PHASE5_B)
    emit({"q4_0_timing": rows})
    b1 = {"name": "matmul_q4_0", "route": "cuda",
          "source": "ggmlsharp_tpu_torch/csrc/matmul_q4_0.cu",
          "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:377",
          "launches": counts["matmul_q4_0"], **forward_sum(rows, "Q4_0", 1),
          "unit": "one decode token: the 129 b=1 launches, cold L2"}
    mma = {"name": "matmul_q4_0_mma", "route": "cuda",
           "source": "ggmlsharp_tpu_torch/csrc/matmul_q4_0.cu",
           "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:377",
           "launches": counts["matmul_q4_0_mma"],
           **forward_sum(rows, "Q4_0", 16),
           "b8_forward": forward_sum(rows, "Q4_0", 8),
           "b128_forward": forward_sum(rows, "Q4_0", 128),
           "unit": "one prompt forward of path a: the 129 launches at b=16 "
                   "(the multi-row instance, csrc/dq_mma.cuh; Q8 activations "
                   "but at the LM head), cold L2; "
                   "b8/b128_forward: the same 129 at b=8 (a serving tick) "
                   "and b=128 (a serving prefill)"}
    return b1, mma


def attn_decode_bound_ms(B, Hq, Hkv, D, npast, kv_bytes=1):
    """Bytes: the live K/V rows (kv_bytes an element; int8 rows with their
    f32 scales), the fresh rows, q and out, once each; operations: 4 * Hq *
    D f32 flops a live key a slot."""
    rows = sum(npast)
    bytes_ = (2 * rows * Hkv * D * kv_bytes
              + (2 * rows * Hkv * 4 if kv_bytes == 1 else 0)
              + 2 * B * Hkv * D * 4 + 2 * B * Hq * D * 4)
    flops = 4 * Hq * D * (rows + B)
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_decode_shape(dev, gen, B, Hq, Hkv, T, D=128, kind="int8"):
    """Cold-L2 kernel, plain and library times of one decode-step layer
    call, every slot at npast = T - 1, beside its bound. The library time
    is scaled_dot_product_attention over a bf16 head-major copy of the
    dequantized live rows and the fresh row (its K/V heads repeated n_rep
    times under GQA), the call alone (the copy is made before timing)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import (_decode_ref, _dequant,
                                                         flash_decode_flat)

    kv_bytes = 1 if kind == "int8" else 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    copies = max(2, -(-4 * L2_BYTES // (B * T * Hkv * D * 2 * kv_bytes)))
    q, kn, vn, caches = decode_inputs(dev, gen, B, Hq, Hkv, T, kind, copies,
                                      D=D)
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
        for rows_, s, new in ((kc, sc.get("k_scale"), kn),
                              (vc, sc.get("v_scale"), vn)):
            d = _dequant(rows_[:, :T - 1],
                         None if s is None else s[:, :T - 1], Hkv)
            d = torch.cat([d, new[:, None]], 1)  # the fresh row last
            kv.append(d.reshape(B, T, Hkv, D).transpose(1, 2)
                      .repeat_interleave(Hq // Hkv, 1)
                      .to(torch.bfloat16).contiguous())
        heads.append(kv)
    qb = q[:, :, None].to(torch.bfloat16)
    ms = time_ms(kern, 100)
    bound, by = attn_decode_bound_ms(B, Hq, Hkv, D, npast, kv_bytes)
    row = {"B": B, "Hq": Hq, "Hkv": Hkv, "T": T, "D": D, "cache": kind,
           "ms": ms, "plain_ms": time_ms(plain, 20),
           "library_ms": time_ms(lambda i: sdpa(qb, *heads[i % copies]),
                                 100),
           "bound_ms": bound, "bound_by": by, "roofline_share": bound / ms,
           "cold_copies": copies}
    del caches, heads
    torch.cuda.empty_cache()
    return row


Q8_CHECK_B = (1, 2, 5, 8, 16, 64, 128)  # both instances; 5: a ragged tile
Q8_RAGGED = ("ragged", 100, 352)  # N a multiple of no tile, K % 256 = 96
Q8_7B_B = (2, 5, 16)  # path f's Q8_0 prompt (b 16) at the Llama-7B shapes


def check_q8_0(dev, gen):
    """Kernel 4's two instances (through mul_mat_q_fused, which picks the
    instance for b) vs plain at every GPT-2 124M and 774M shape and
    Q8_RAGGED (a short last chunk), b in Q8_CHECK_B, and at every Llama-7B
    shape (path f's Q8_0 prompt: long runs of chunks a CTA, the LM head on
    the 128-row route for f32 x), b in Q8_7B_B, with the Q8_0 activation
    round trip (the int8 route) and f32 x (three bf16 planes in mm_dot
    "f32", one in "bf16"; each against the plain version of its mode). Tolerance:
    the two sum f32 terms in different orders; allow 1e-5 of sum_k |x_k
    w_nk|, x as the call rounds it (2^-24 is 6e-8 a rounding). Then whether
    a row's result is bit for bit the same at every b >= 2
    (rows_independent_of_b at c_attn 124M, the 7B w_down 4096 x 11008 and
    Q8_RAGGED, b 2-128), b = 1 within the bar; raises if not."""
    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused
    from ggmlsharp_tpu_torch.models.gpt2 import random_q8_0
    from ggmlsharp_tpu_torch.ops import mul_mat_q, quantize_activations
    from ggmlsharp_tpu_torch.ops.matmul import round_bf16
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    worst, rows = 0.0, []
    shapes = [(f"{tag}_{name}", n, k, Q8_CHECK_B) for tag, cfg in
              gpt2_configs() for name, n, k in gpt2_shapes(cfg.n_embd)]
    shapes += [(*Q8_RAGGED, Q8_CHECK_B)]
    shapes += [(f"7B_{name}", n, k, Q8_7B_B) for name, n, k, _ in Q4_SHAPES]
    for name, n, k, bs in shapes:
        w = random_q8_0(n, k, gen, dev)
        wabs = dequantize(w).abs()
        for b in bs:
            x = torch.randn((b, k), generator=gen, device=dev)
            for qa, mode in ((True, "f32"), (False, "f32"), (False, "bf16")):
                got = mul_mat_q_fused(w, x, quantize_acts=qa, mode=mode)
                want = mul_mat_q(w, x, quantize_acts=qa, mode=mode)
                xr = dequantize(quantize_activations(x, GType.Q8_0)) if qa \
                    else (round_bf16(x) if mode == "bf16" else x)
                scale = xr.abs() @ wabs.T
                err = (got - want).abs()
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= 1e-5 * scale).all())
                e = float(err.max())
                worst = max(worst, e)
                rows.append({"shape": name, "b": b, "n": n, "k": k,
                             "acts": "q8" if qa else "f32", "mm_dot": mode,
                             "max_abs_err": e,
                             "max_err_over_sum_abs": float(
                                 (err / scale).max()),
                             "ok": ok})
                if not ok:
                    emit({"q8_0_check": rows})
                    raise SystemExit(f"Q8_0 kernel disagrees: {rows[-1]}")
        del w, wabs
    same = rows_independent_of_b(dev, gen, "Q8_0",
                                 ((2304, 768), (4096, 11008),
                                  Q8_RAGGED[1:3]), Q8_CHECK_B[1:])
    emit({"q8_0_check": rows, "q8_0_rows_vs_b": same})
    if not same["ok"]:
        raise SystemExit(f"a Q8_0 row's result depends on b: {same}")
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


MLP_CHECK_ROWS = (1, 2, 5, 16, 64)  # 1: the b = 1 instance; 5: a ragged tile
MLP_SHORT_E = 384  # K = 384 ends W1's products in a short chunk
MLP_RING_E = 2048  # the b = 1 instance: shares past a CTA, a ring of pieces


def check_mlp_fused(dev, gen):
    """Kernel 8 (flash_ff_q8, which picks the instance for the rows) vs
    plain _ff_ref at both GPT-2 widths and at E MLP_SHORT_E, rows in
    MLP_CHECK_ROWS, and at E MLP_RING_E at one row (the b = 1 instance's
    weight shares in a ring of pieces), with the Q8_0 round trip of the input (the multi-row
    instance takes its int8 values) and with f32 x in each mm_dot mode,
    each against the plain version of its mode. Tolerance: f32 summation
    order through two chained products: h may differ by 1e-5 of s1 = sum
    |x w1| (x as the call rounds it; GELU's slope is at most 1.13), so y by
    1e-5 of (1.13 s1 + |h|) |W2|^T. Then whether a row's result is bit for
    bit the same at every row count that takes the multi-row instance."""
    import torch

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_ref, flash_ff_q8
    from ggmlsharp_tpu_torch.ops import gelu, mul_mat_q, quantize_activations
    from ggmlsharp_tpu_torch.ops.matmul import round_bf16
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    worst, rows, same = 0.0, [], {}
    widths = [(tag, cfg.n_embd, MLP_CHECK_ROWS)
              for tag, cfg in gpt2_configs()] \
        + [("short", MLP_SHORT_E, MLP_CHECK_ROWS), ("ring", MLP_RING_E, (1,))]
    for tag, E, row_set in widths:
        ((w1, b1, w2, b2),) = mlp_inputs(E, gen, dev)
        w1abs, w2abs = dequantize(w1).abs(), dequantize(w2).abs()
        xs = torch.randn((max(row_set), E), generator=gen, device=dev)
        for qa, mode in ((True, "f32"), (False, "f32"), (False, "bf16")):
            acts = "q8" if qa else mode
            ys = {}
            for n_rows in row_set:
                x = xs[:n_rows].contiguous()
                got = flash_ff_q8(w1, b1, w2, b2, x, quantize_acts=qa,
                                  mode=mode)
                want = _ff_ref(w1, b1, w2, b2, x, quantize_acts=qa, mode=mode)
                xr = dequantize(quantize_activations(x, GType.Q8_0)) if qa \
                    else (round_bf16(x) if mode == "bf16" else x)
                h = gelu(mul_mat_q(w1, xr, quantize_acts=False) + b1)
                scale = (1.13 * (xr.abs() @ w1abs.T) + h.abs()) @ w2abs.T
                err = (got - want).abs()
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= 1e-5 * scale).all())
                e = float(err.max())
                worst = max(worst, e)
                ys[n_rows] = got
                rows.append({"config": tag, "E": E, "rows": n_rows,
                             "acts": acts, "max_abs_err": e,
                             "max_err_over_bar": float(
                                 (err / (1e-5 * scale)).max()), "ok": ok})
                if not ok:
                    emit({"mlp_fused_check": rows})
                    raise SystemExit(f"mlp_fused_q8 disagrees: {rows[-1]}")
            top = ys[row_set[-1]]
            same[f"{tag} {acts}"] = all(torch.equal(ys[r], top[:r])
                                        for r in row_set if r >= 2)
        del w1, w2, w1abs, w2abs
    emit({"mlp_fused_check": rows, "mlp_fused_rows_vs_b": same})
    if not all(same.values()):
        raise SystemExit(f"a kernel-8 row's result depends on the rows: "
                         f"{same}")
    return worst


def gpt2_blocks(cfg, n, seed):
    """n random GPT-2 blocks of cfg's width (non-trivial gains and biases)."""
    import dataclasses

    from ggmlsharp_tpu_torch.models import gpt2

    small = dataclasses.replace(cfg, n_layer=n, n_vocab=256)
    return gpt2.synthetic_q8_0_params(small, seed)["blocks"]


def gpt2_layer_check_configs():
    """Kernel 11's check widths: 124M, 355M, 774M (every share of the four
    weights fits a CTA's shared memory at once) and E 1536, H 12, F 6144 (it
    does not: pieces in a ring), each passing gpt2_layer_fuse_supported."""
    from ggmlsharp_tpu_torch.models import gpt2

    return [("124M", gpt2.GPT2_124M), ("355M", gpt2.GPT2_355M),
            ("774M", gpt2.GPT2_774M),
            ("E1536", gpt2.GPT2Config(n_embd=1536, n_head=12))]


def check_gpt2_layer(dev, gen):
    """Kernel 11 vs plain _layer_ref at gpt2_layer_check_configs' widths,
    bf16 and f32 caches, T in {256, 1024}, npast in {0, 1, T/2, T - 1}.
    Tolerance (all f32, values of magnitude ~4): y through five chained
    products and an online softmax 5e-5 + 5e-5 |want|; k_new, v_new (one
    product after the layer norm) 2e-5 + 2e-5 |want|. One wrong or missing
    cache row would move y by ~1e-3."""
    import torch

    from ggmlsharp_tpu_torch.kernels.gpt2_layer import (
        _layer_ref, gpt2_layer_fuse_supported, gpt2_layer_step)

    worst, rows = 0.0, []
    for tag, cfg in gpt2_layer_check_configs():
        E = cfg.n_embd
        if not gpt2_layer_fuse_supported(E, 4 * E):
            raise SystemExit(f"gpt2_layer check width {tag} is not fusable")
        blk = gpt2_blocks(cfg, 1, SEED + 1)[0]
        cases = [(dt, T, n) for dt in (torch.bfloat16, torch.float32)
                 for T in (256, 1024) for n in (0, 1, T // 2, T - 1)]
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


def gpt2_b1_launches(cfg):
    """Expected launches of path c's generate over the flat bf16 cache."""
    from ggmlsharp_tpu_torch import kernels

    L = cfg.n_layer
    return dict.fromkeys(kernels.LAUNCHES, 0) | {
        "gpt2_layer": L * N_NEW,           # one a block a decode step
        # the prefill's 16 rows: kernel 8's multi-row instance
        **dq_launches("mlp_fused_q8", L, 0),
        "flash_attn": L,                   # prefill only
        # prefill: c_attn, c_proj a block + LM head at 16 rows (the
        # multi-row instance); a decode step: the LM head at one row
        **dq_launches("matmul_q8_0", 2 * L + 1, N_NEW)}


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
    want = gpt2_b1_launches(cfg)
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


def run_gpt2_per_op(tag, cfg, params, prompt, n_new=MLP_STEPS):
    """c2. GPT-2 at b = 1 over the head-major bf16 cache, which takes the
    per-op route (the whole-block kernel needs the flat cache): the prompt
    (kernel 4 and kernel 8 at 16 rows, flash) and ``n_new`` greedy tokens,
    each step kernel 4 at one row (c_attn, c_proj, the LM head) and kernel
    8's b = 1 instance once a block; counters reset just before."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import gpt2, sampling

    cache = gpt2.new_cache(cfg, 1, flat=False)
    torch.cuda.synchronize()
    kernels.reset_launches()
    toks, cache = sampling.generate(gpt2.forward, cfg, params, prompt, cache,
                                    n_new)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    L = cfg.n_layer
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn": L,
        **dq_launches("mlp_fused_q8", L, L * n_new),
        **dq_launches("matmul_q8_0", 2 * L + 1, (2 * L + 1) * n_new)}
    emit({"gpt2_per_op_path": {"config": tag, "tokens": toks[0].tolist(),
                               "launches": counts,
                               "expected_launches": want}})
    if counts != want:
        raise SystemExit(f"GPT-2 {tag} per-op launch counts {counts} != "
                         f"{want}")
    if toks.shape != (1, n_new) or int(cache.length[0]) != PROMPT_LEN + n_new:
        raise SystemExit(f"GPT-2 {tag} per-op path: bad tokens {toks}")
    return toks, counts


Q8_TIMING_B = (1, 2, 16, 128)  # decode, GPT-2 INT8 serving, a prompt, a prefill


def gpt2_q8_shapes(cfg):
    """The Q8_0 matmuls a GPT-2 forward runs through kernel 4, (name, N, K,
    launches a forward): c_attn and c_proj a block, the LM head (wte) once
    (the MLP is kernel 8)."""
    per = {"c_attn": cfg.n_layer, "c_proj": cfg.n_layer, "wte": 1}
    return [(name, n, k, per[name]) for name, n, k in gpt2_shapes(cfg.n_embd)
            if name in per]


def time_q8_0(dev, gen, counts, bs=Q8_TIMING_B, plain=True):
    """Kernel 4 through the calls the paths make (time_weight_rows: Q8_0
    activations through mma_q8_matmul at b >= 2, f32 x at the LM head and
    in the weight-only rows) at each GPT-2 shape it runs, b in ``bs``; the
    kernels-line rows of its b = 1 instance (a decode token of GPT-2 124M:
    the LM head, f32 x) and its multi-row instance (path c's 124M prompt
    forward: c_attn, c_proj at b = 16 with Q8_0 activations, the LM head
    with f32 x; also 774M's, and GPT-2 INT8 serving's decode step at b = 2,
    weight-only: f32 x). Returns (timing rows, b1 row, multi-row row)."""
    rows = []
    for tag, cfg in gpt2_configs():
        for r in time_weight_rows(dev, gen, "Q8_0", gpt2_q8_shapes(cfg), bs,
                                  plain):
            rows.append({"config": tag, **r})
    emit({"q8_0_timing": rows})
    if not plain:
        return rows, None, None
    by = {tag: [r for r in rows if r["config"] == tag] for tag, _ in
          gpt2_configs()}
    r = next(r for r in by["124M"] if r["shape"] == "wte" and r["b"] == 1)
    b1 = {"name": "matmul_q8_0", "route": "cuda",
          "source": "ggmlsharp_tpu_torch/csrc/matmul_q8_0.cu",
          "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:572",
          "launches": counts["matmul_q8_0"],
          **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")},
          "unit": "one decode token of GPT-2 124M: the LM head launch "
                  "(50257 x 768, b=1, f32 x), cold L2; library = bf16 "
                  "torch.matmul"}
    mma = {"name": "matmul_q8_0_mma", "route": "cuda",
           "source": "ggmlsharp_tpu_torch/csrc/matmul_q8_0.cu",
           "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:572",
           "launches": counts["matmul_q8_0_mma"],
           **forward_sum(by["124M"], "Q8_0", 16),
           "forward_774m": forward_sum(by["774M"], "Q8_0", 16),
           "b2_forward": forward_sum(by["124M"], "Q8_0", 2, "f32"),
           "unit": "one prompt forward of path c 124M: c_attn, c_proj (Q8_0 "
                   "activations, the int8 route) x 12 and the LM head (f32 "
                   "x, three bf16 planes) at b=16, cold L2 (the multi-row "
                   "instance, csrc/dq_mma.cuh); forward_774m: the same for "
                   "774M; b2_forward: GPT-2 124M INT8 serving's decode step "
                   "(weight-only: f32 x) at b=2; library = bf16 torch.matmul"}
    return rows, b1, mma


def mlp_bound_ms(B, E, acts="f32"):
    """Bytes: both Q8_0 weights, both bf16 biases, x as the call takes it
    (``acts`` "q8": its Q8_0 values and block scales; "f32", "bf16": f32)
    and y, once each (h is no tensor of the model). Operations, the least
    any implementation needs on this card: W1's product int8 x int8 on the
    int8 tensor cores after the Q8_0 round trip, else f32 x exactly as
    three bf16 products a term ("f32") or one ("bf16": x rounded to bf16);
    W2's operand, the f32 h, three bf16 products a term (it is never
    rounded)."""
    F = 4 * E
    x_bytes = B * E + B * E // 32 * 2 if acts == "q8" else B * E * 4
    bytes_ = 2 * F * E * 34 // 32 + (F + E) * 2 + x_bytes + B * E * 4
    t_bytes = bytes_ / HBM_BYTES_S
    w1_ops = (2 * B * F * E / INT8_OP_S if acts == "q8"
              else (6 if acts == "f32" else 2) * B * F * E / BF16_FLOP_S)
    t_ops = w1_ops + 6 * B * E * F / BF16_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


MLP_TIMING_ROWS = (1, 2, 8, 16, 64)  # decode, serving ticks, the prompt, the gate


def time_mlp_fused(dev, gen, counts=None, plain=True,
                   n_rows_set=MLP_TIMING_ROWS):
    """Cold-L2 kernel, plain and library times of kernel 8 at both GPT-2
    widths and each row count of ``n_rows_set``, in rows by activations:
    "q8", the operands the paths hand it with the Q8_0 round trip (its
    values and scales from MMA_MIN_ROWS rows on where the package has the
    multi-row instance, else their dequantized f32 copy), and f32 x, in
    mm_dot "f32" and, where the package reads the mode, "bf16" (path s:
    weight-only). Library: two bf16 torch.matmuls around
    F.gelu(approximate="tanh") over weights dequantized to bf16. At one row
    also the two routes models/gpt2.py can take, in each activation kind
    ("q8": with the Q8_0 round trip; else weight-only in that mm_dot mode):
    the fused one (flash_ff_q8), fused_route_ms, and the unfused one
    (linear over c_fc, gelu, linear over c_proj: kernel 4 twice),
    unfused_ms. With ``counts``, also returns the kernels-line rows of the
    b = 1 instance (1 row, f32 x in the default mode) and the multi-row
    instance (16 rows, Q8_0 x: the prompt of path c, GPT-2 124M)."""
    import inspect

    import torch
    import torch.nn.functional as F_

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels import _build
    from ggmlsharp_tpu_torch.kernels.mlp_fused import (_ff_ref, flash_ff_q8,
                                                       mlp_fused_q8)
    from ggmlsharp_tpu_torch.models.common import linear
    from ggmlsharp_tpu_torch.ops import gelu, quantize_activations
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    multi = "mlp_fused_q8_mma" in _build.KERNELS
    moded = "mode" in inspect.signature(mlp_fused_q8).parameters
    rows = []
    for tag, cfg in gpt2_configs():
        E = cfg.n_embd
        copies = max(2, -(-4 * L2_BYTES // (8 * E * E * 34 // 32)))
        ws = mlp_inputs(E, gen, dev, copies)
        wb = [(dequantize(w1).bfloat16(), dequantize(w2).bfloat16())
              for w1, _, w2, _ in ws]
        for n_rows in n_rows_set:
            x = torch.randn((n_rows, E), generator=gen, device=dev)
            aq = quantize_activations(x, GType.Q8_0)
            xr = dequantize(aq)
            for acts in ("q8", "f32") + (("bf16",) if moded else ()):
                q8 = acts == "q8" and multi and n_rows >= 2
                xa = aq if q8 else (xr if acts == "q8" else x)
                kw = {"mode": "f32" if acts == "q8" else acts} if moded \
                    else {}
                xb = (xr if acts == "q8" else x).bfloat16()

                def lib(i, xb=xb):
                    (w1, w2), (_, b1, _, b2) = wb[i % copies], ws[i % copies]
                    return F_.gelu(xb @ w1.T + b1, approximate="tanh") \
                        @ w2.T + b2

                bound, by = mlp_bound_ms(n_rows, E, acts)
                ms = time_ms(lambda i, xa=xa, kw=kw: mlp_fused_q8(
                    xa, *ws[i % copies], **kw), 48)
                row = {"config": tag, "rows": n_rows, "acts": acts, "ms": ms,
                       "library_ms": time_ms(lib, 48), "bound_ms": bound,
                       "bound_by": by, "roofline_share": bound / ms,
                       "cold_copies": copies}
                if n_rows == 1:
                    qa = acts == "q8"

                    def unfused(i, qa=qa):
                        w1, b1, w2, b2 = ws[i % copies]
                        h = gelu(linear(w1, x, b1, quantize_acts=qa))
                        return linear(w2, h, b2, quantize_acts=qa)

                    with mm_dot("f32" if qa or not moded else acts):
                        row["fused_route_ms"] = time_ms(
                            lambda i, qa=qa, kw=kw: flash_ff_q8(
                                *ws[i % copies], x, quantize_acts=qa, **kw),
                            48)
                        row["unfused_ms"] = time_ms(unfused, 48)
                if plain:
                    row["plain_ms"] = time_ms(
                        lambda i, xv=xr if acts == "q8" else x, kw=kw: _ff_ref(
                            *ws[i % copies], xv, quantize_acts=False, **kw), 6)
                rows.append(row)
        del ws, wb
        torch.cuda.empty_cache()
    emit({"mlp_fused_timing": rows})
    if counts is None:
        return rows
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    r124 = [r for r in rows if r["config"] == "124M"]
    r1 = next(r for r in r124 if r["rows"] == 1 and r["acts"] == "bf16")
    r16 = next(r for r in r124 if r["rows"] == PROMPT_LEN
               and r["acts"] == "q8")
    by_rows = lambda sel: {f"{r['config']} {r['rows']} {r['acts']}": r[sel]
                           for r in rows}
    b1 = {"name": "mlp_fused_q8", "route": "cuda",
          "source": "ggmlsharp_tpu_torch/csrc/mlp_fused_q8.cu",
          "replaces": "ggmlsharp_tpu/kernels/mlp_fused.py:130",
          "launches": counts["mlp_fused_q8"],
          **{key: r1[key] for key in keys},
          "fused_route_ms": r1["fused_route_ms"],
          "unfused_ms": r1["unfused_ms"],
          "one_row_ms": {f"{r['config']} {r['acts']}": r["ms"] for r in rows
                         if r["rows"] == 1},
          "unit": "one GPT-2 124M MLP call at 1 row: E 768, F 3072, f32 x "
                  "in mm_dot bf16 (the default), cold L2; library = two "
                  "bf16 torch.matmuls + F.gelu; fused_route_ms / unfused_ms: "
                  "flash_ff_q8 and kernel 4 + gelu + kernel 4, weight-only"}
    mma = {"name": "mlp_fused_q8_mma", "route": "cuda",
           "source": "ggmlsharp_tpu_torch/csrc/mlp_fused_q8.cu",
           "replaces": "ggmlsharp_tpu/kernels/mlp_fused.py:130",
           "launches": counts["mlp_fused_q8_mma"],
           **{key: r16[key] for key in keys},
           "rows_ms": by_rows("ms"), "rows_library_ms": by_rows("library_ms"),
           "rows_bound_ms": by_rows("bound_ms"),
           "unit": "one prefill MLP call of GPT-2 124M: 16 rows, Q8_0 x, E "
                   "768, F 3072, cold L2 (the multi-row instance, "
                   "csrc/dq_mma.cuh: W1 with gelu(+ b1) in its epilogue, W2 "
                   "with + b2); library = two bf16 torch.matmuls + F.gelu"}
    return rows, b1, mma


def layer_bound_ms(E, npast, kv_bytes=2):
    """Bytes: the four Q8_0 weights, the live K/V rows (kv_bytes an
    element), biases and gains, x, y, k_new, v_new once each. Operations:
    f32 FMAs of the four products and of attention over the live rows."""
    bytes_ = 12 * E * E * 34 // 32 + 2 * npast * E * kv_bytes + 13 * E * 2 \
        + 16 * E
    flops = 2 * 12 * E * E + 4 * (npast + 1) * E
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


GPT2_LAYER_TIMING = [(256, 32, "bf16"), (256, 32, "f32"), (1024, 1023, "bf16"),
                     (1024, 1023, "f32")]  # (T, npast, cache)
LAYER_NO_MATVEC = ("LAYER_NO_MATVEC=1",)  # kernels 10, 11 without products


def time_gpt2_layer(dev, gen, plain=True):
    """Cold-L2 kernel and plain times of one decode step's block call at both
    widths, at GPT2_LAYER_TIMING's cases: T 256 (the path's bucket) at npast
    32 (the path's steps run 16 to 47) and T 1024 at npast 1023, bf16 and
    f32 caches; each call a different block's weights, as a decode step
    walks the layers. Also the build with LAYER_NO_MATVEC (no weight
    streamed, no product: the norms, barriers, attention and merge alone)
    at the first case, no_matvec_ms. No single PyTorch call computes a
    whole block: library_ms is null."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.kernels.gpt2_layer import _layer_ref, gpt2_layer_step

    rows = []
    for tag, cfg in gpt2_configs():
        E = cfg.n_embd
        copies = max(2, -(-4 * L2_BYTES // (12 * E * E * 34 // 32)))
        blocks = gpt2_blocks(cfg, copies, SEED + 2)
        x = torch.randn((1, E), generator=gen, device=dev)
        for T, npast, cache in GPT2_LAYER_TIMING:
            dt = getattr(torch, _DT[cache])
            kc = torch.randn((T, E), generator=gen, device=dev).to(dt)
            vc = torch.randn((T, E), generator=gen, device=dev).to(dt)
            np_t = torch.tensor(npast, dtype=torch.int32, device=dev)

            def kern(i):
                return gpt2_layer_step(blocks[i % copies], x, kc, vc, np_t,
                                       cfg.n_head, cfg.ln_eps)

            bound, by = layer_bound_ms(E, npast, dt.itemsize)
            ms = time_ms(kern, 2 * copies)
            row = {"config": tag, "T": T, "npast": npast, "cache": cache,
                   "ms": ms, "library_ms": None, "bound_ms": bound,
                   "bound_by": by, "roofline_share": bound / ms,
                   "cold_copies": copies}
            if plain:
                row["plain_ms"] = time_ms(lambda i: _layer_ref(
                    blocks[i % copies], x, kc, vc, np_t, cfg.n_head,
                    cfg.ln_eps), 8)
            if not rows or rows[-1]["config"] != tag:
                kernels.set_defines("gpt2_layer", LAYER_NO_MATVEC)
                try:
                    row["no_matvec_ms"] = time_ms(kern, 2 * copies)
                finally:
                    kernels.set_defines("gpt2_layer", ())
            rows.append(row)
        del blocks
        torch.cuda.empty_cache()
    emit({"gpt2_layer_timing": rows})
    r, big = rows[0], rows[len(GPT2_LAYER_TIMING)]
    return {"name": "gpt2_layer", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/gpt2_layer.cu",
            "replaces": "ggmlsharp_tpu/kernels/gpt2_layer.py:131",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by") if key in r},
            "no_matvec_ms": r["no_matvec_ms"],
            "gpt2_774m": {key: big[key] for key in
                          ("ms", "plain_ms", "bound_ms", "bound_by",
                           "no_matvec_ms") if key in big},
            "shapes": rows,
            "unit": "one block call of a GPT-2 124M decode step: E 768, "
                    "12 heads, T 256, npast 32, bf16 KV, cold L2 (gpt2_774m: "
                    "E 1280, 20 heads); no library call computes a block"}


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


SILU_CHECK_ROWS = (1, 2, 5, 8, 16, 33, 64)  # 1: the b = 1 instance
SILU_SHORT = (384, 640)  # (E, F): both products end in a short chunk
SILU_13B = (5120, 13824)  # LLAMA_13B's (E, F), at one row


def check_mlp_fused_silu(dev, gen):
    """Kernel 9's two instances vs plain _ff_silu_ref at Llama-7B's E and F,
    rows in SILU_CHECK_ROWS, at SILU_SHORT (E and F not multiples of the
    multi-row instance's 256-column chunk) and, one row, at SILU_13B, with
    and without the Q8_0 round trip of the input (made by the same PyTorch
    code on both sides). Tolerance: f32 summation order through two chained
    products. g and u may each differ by 1e-5 of their s = sum |x w|;
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
    worst, rows = 0.0, []
    for (E, F), row_set in (((cfg.n_embd, cfg.n_ff), SILU_CHECK_ROWS),
                            (SILU_SHORT, (1, 2, 5, 16, 64)), (SILU_13B, (1,))):
        w1 = llama.random_q4_0(2 * F, E, gen, dev)
        w2 = llama.random_q4_0(E, F, gen, dev)
        w1abs, w2abs = dequantize(w1).abs(), dequantize(w2).abs()
        for n_rows, qa in ((r, q) for r in row_set for q in (False, True)):
            x = torch.randn((n_rows, E), generator=gen, device=dev)
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
            rows.append({"E": E, "F": F, "rows": n_rows, "quantize_acts": qa,
                         "max_abs_err": e, "max_abs": float(want.abs().max()),
                         "max_err_over_scale": float((err / scale).max()),
                         "ok": ok})
            if not ok:
                emit({"mlp_fused_silu_check": rows})
                raise SystemExit(f"mlp_fused_silu_q4 disagrees: {rows[-1]}")
        del w1, w2, w1abs, w2abs
    emit({"mlp_fused_silu_check": rows})
    return worst


def check_one_row_repeats(dev, gen):
    """The one-row instances of kernels 8 (GPT-2 124M, mm_dot "bf16") and 9
    (Llama-7B), with kernel 11 (124M, T 256, npast 32) between them, three
    times over on one side stream: kernels 8 and 11 take turns on the
    stream's tag word, kernel 9 reads it too. Then the same nine launches
    captured in a CUDA graph on that stream (its sync and exchange buffers
    made before the capture, so no replay starts them afresh) and replayed
    twice. Every launch's bits must equal the first launch's of its kernel:
    a stale tag or counter would read an earlier launch's values or hang.
    Returns the launches compared."""
    import torch

    from ggmlsharp_tpu_torch.kernels.gpt2_layer import gpt2_layer_step
    from ggmlsharp_tpu_torch.kernels.mlp_fused import (mlp_fused_q8,
                                                       mlp_fused_silu_q4)
    from ggmlsharp_tpu_torch.models import gpt2, llama
    from ggmlsharp_tpu_torch.models.captured import collector_off

    gcfg, lcfg = gpt2.GPT2_124M, llama.LLAMA_7B
    E = gcfg.n_embd
    ((w1, b1, w2, b2),) = mlp_inputs(E, gen, dev)
    blk = gpt2_blocks(gcfg, 1, SEED + 3)[0]
    kc = torch.randn((256, E), generator=gen, device=dev).bfloat16()
    np_t = torch.tensor(32, dtype=torch.int32, device=dev)
    x8 = torch.randn((1, E), generator=gen, device=dev)
    wg = llama.random_q4_0(2 * lcfg.n_ff, lcfg.n_embd, gen, dev)
    wd = llama.random_q4_0(lcfg.n_embd, lcfg.n_ff, gen, dev)
    x9 = torch.randn((1, lcfg.n_embd), generator=gen, device=dev)

    def seq():
        out = []
        for _ in range(3):
            out.append(mlp_fused_q8(x8, w1, b1, w2, b2, mode="bf16"))
            out.append(gpt2_layer_step(blk, x8, kc, kc, np_t, gcfg.n_head,
                                       gcfg.ln_eps)[0])
            out.append(mlp_fused_silu_q4(x9, wg, wd))
        return out

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = seq()
        graph = torch.cuda.CUDAGraph()
        with collector_off(), torch.cuda.graph(graph, stream=side):
            captured = seq()
    torch.cuda.synchronize()
    bad = [i for i in range(3, 9) if not torch.equal(eager[i], eager[i % 3])]
    for rep in range(2):
        graph.replay()
        torch.cuda.synchronize()
        bad += [f"replay {rep} launch {i}" for i in range(9)
                if not torch.equal(captured[i], eager[i % 3])]
    emit({"one_row_repeats": {"launches": 9 * 3, "differ": bad}})
    if bad:
        raise SystemExit(f"a one-row launch's bits differ from its first: "
                         f"{bad}")
    return 9 * 3


# whole-block check shapes: (label, n_head_kv, n_ff, rope mode)
LAYER_SHAPES = [("7b_mha", 32, 11008, 0), ("7b_mha_neox", 32, 11008, 2),
                # Mistral-7B's block: GQA n_rep 4, F 14336 (57 KB of shared
                # memory for the gated product: over the 48 KB default)
                ("gqa4_f14336", 8, 14336, 0)]
LAYER_TOL = (5e-5, 2e-5, 2e-5)  # y, k_new, v_new: tol + tol * |want|


def check_llama_layer(dev, gen):
    """Kernel 10 vs plain _layer_ref at Llama-7B's block (MHA, D 128), rope
    modes 0 and 2, and at one GQA shape; T 256 with npast in {0, 32, T - 1}
    over a bf16 cache, npast 100 over an f32 cache, T 2048 at npast 2047
    over both, and a ragged T 777 (no multiple of the attention chunks) at
    npast 500 (bf16) and 776 (f32). Tolerance (all f32, values of magnitude ~4; gpt2_layer's bars): y
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
            + [(torch.float32, 256, 100), (torch.bfloat16, 2048, 2047),
               (torch.float32, 2048, 2047), (torch.bfloat16, 777, 500),
               (torch.float32, 777, 776)]
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


ATTN_LAYOUT_RAGGED = [  # as ATTN_LAYOUT_CASES: T 777 over 12 splits, GQA 2
    ("attn_gqa2_T777_ragged", 3, 16, 8, 777, [776, 900, 301]),
]


def check_attn_layout(dev, gen, cases=ATTN_LAYOUT_CASES,
                      tag="attn_layout_check"):
    """Kernel 3 with the "attn" lane map vs its plain version (permute to
    element order, _decode_ref or _decode_ref_split at the kernel's splits,
    permute back), mm_dot "f32": rtol 2e-4 / atol 2e-5, as for the heads
    map (whose check also holds "bf16")."""
    import torch

    from ggmlsharp_tpu_torch.kernels.attn_decode import (_decode_ref_attn,
                                                         flash_decode_flat_attn)

    worst, rows = 0.0, []
    for label, B, Hq, Hkv, T, npast in cases:
        q, kn, vn, ((kc, vc, _),) = decode_inputs(dev, gen, B, Hq, Hkv, T,
                                                  "bf16")
        np_t = torch.tensor(npast, dtype=torch.int32, device=dev)
        args = (q.reshape(B, Hq * 128), kn, vn, kc, vc, np_t, Hq, Hkv, 128)
        splits = decode_splits_on(dev, B, Hkv, T)
        got = flash_decode_flat_attn(*args, mode="f32")
        row = {"case": label, "splits": splits, "ok": True}
        for name, want in (("dense", _decode_ref_attn(*args)),
                           ("split", _decode_ref_attn(*args, splits=splits))):
            torch.cuda.synchronize()
            err = (got - want).abs()
            row["ok"] &= bool(torch.isfinite(got).all()) and bool(
                (err <= 2e-5 + 2e-4 * want.abs()).all())
            row[f"max_abs_err_{name}"] = float(err.max())
            worst = max(worst, float(err.max()))
        rows.append(row)
        if not row["ok"]:
            emit({tag: rows})
            raise SystemExit(f"attn_decode (attn lane map) disagrees in "
                             f"case {label}")
    emit({tag: rows})
    return worst


def check_ragged(dev, gen):
    """Kernels 2 and 3 at ragged edges (FLASH_RAGGED, ATTN_RAGGED for both
    lane maps), at the bars of their regular checks."""
    return max(check_flash(dev, gen, FLASH_RAGGED, "flash_ragged_check"),
               check_attn_decode(dev, gen, ATTN_RAGGED,
                                 "attn_decode_ragged_check"),
               check_attn_layout(dev, gen, ATTN_LAYOUT_RAGGED,
                                 "attn_layout_ragged_check"))


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


def mlp_silu_bound_ms(B, E, F, q8_acts=False):
    """Bytes: both Q4_0 weights (18 B a 32-weight block), x as the timed
    call takes it (f32, or with ``q8_acts`` its Q8_0 values and block
    scales) and y, once each (the gated product is no tensor of the model).
    Operations, the least any implementation needs on this card: the
    gate/up product int8 x int4 on the int8 tensor cores after the Q8_0
    round trip, else f32 x exactly as three bf16 products a term; the down
    product's operand, the f32 gated product, three bf16 products a term
    (it is never quantized)."""
    x_bytes = B * E + B * E // 32 * 2 if q8_acts else B * E * 4
    bytes_ = 3 * E * F * 18 // 32 + x_bytes + B * E * 4
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = (4 * B * F * E / INT8_OP_S if q8_acts
             else 12 * B * F * E / BF16_FLOP_S) + 6 * B * E * F / BF16_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


SILU_TIMING_ROWS = (1, 2, 8, 16, 64)  # decode, serving ticks, a prompt, the gate


SILU_TIMING_ONE_ROW = (("short", SILU_SHORT), ("13B", SILU_13B))  # 1 row only


def time_mlp_fused_silu(dev, gen, counts=None, plain=True,
                        n_rows_set=SILU_TIMING_ROWS):
    """Cold-L2 kernel, plain and library times of one Llama-7B MLP call at
    each row count of ``n_rows_set`` (and of one row at each shape of
    SILU_TIMING_ONE_ROW), in two rows where the package has the multi-row
    instance: "f32", x as it comes, and "q8", the operands the path hands
    it (the Q8_0 activations of quantize_activations(x, Q4_0) from
    MMA_MIN_ROWS rows on; one row, and a package without the instance,
    takes their dequantized f32 copy). Library: two bf16 torch.matmuls
    around F.silu over weights dequantized to bf16. At one row also the two
    routes models/llama.py takes with the Q8_0 round trip: the fused one
    (flash_ff_silu_q4: the round trip, then the kernel), fused_route_ms, and
    the unfused one (linear over w_gate_up, silu(g) * u, linear over w_down:
    matmul_q4_0 twice, each after its round trip), unfused_ms. With
    ``counts``, also returns the kernels-line rows of the b = 1 instance (1
    row) and the multi-row instance (16 rows, the prompt of paths d1 and
    d2, Q8_0 activations)."""
    import torch
    import torch.nn.functional as F_

    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.kernels import _build
    from ggmlsharp_tpu_torch.kernels.mlp_fused import (_ff_silu_ref,
                                                       flash_ff_silu_q4,
                                                       mlp_fused_silu_q4)
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.models.common import linear
    from ggmlsharp_tpu_torch.ops import quantize_activations, silu
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    multi = "mlp_fused_silu_q4_mma" in _build.KERNELS
    cfg = llama.LLAMA_7B
    rows = []
    shapes = [("7B", (cfg.n_embd, cfg.n_ff), n_rows_set)] \
        + [(tag, ef, (1,)) for tag, ef in SILU_TIMING_ONE_ROW]
    for tag, (E, F), row_set in shapes:
        copies = max(2, -(-4 * L2_BYTES // (3 * E * F * 18 // 32)))
        ws = [(llama.random_q4_0(2 * F, E, gen, dev),
               llama.random_q4_0(E, F, gen, dev)) for _ in range(copies)]
        wb = [(dequantize(w1).bfloat16(), dequantize(w2).bfloat16())
              for w1, w2 in ws]
        for n_rows in row_set:
            x = torch.randn((n_rows, E), generator=gen, device=dev)
            aq = quantize_activations(x, GType.Q4_0)
            xr = dequantize(aq)
            for acts in ("f32", "q8"):
                q8 = acts == "q8" and multi and n_rows >= 2
                xa = aq if q8 else (x if acts == "f32" else xr)
                xb = xa.bfloat16() if not q8 else xr.bfloat16()

                def lib(i, xb=xb, F=F):
                    w1, w2 = wb[i % copies]
                    gu = xb @ w1.T
                    return (F_.silu(gu[:, :F]) * gu[:, F:]) @ w2.T

                bound, by = mlp_silu_bound_ms(n_rows, E, F, q8)
                ms = time_ms(lambda i, xa=xa: mlp_fused_silu_q4(
                    xa, *ws[i % copies]), 48)
                row = {"config": tag, "rows": n_rows, "acts": acts, "ms": ms,
                       "library_ms": time_ms(lib, 48), "bound_ms": bound,
                       "bound_by": by, "roofline_share": bound / ms,
                       "cold_copies": copies}
                if n_rows == 1 and acts == "q8":

                    def unfused(i, F=F):
                        w1, w2 = ws[i % copies]
                        gu = linear(w1, x, quantize_acts=True)
                        return linear(w2, silu(gu[..., :F]) * gu[..., F:],
                                      quantize_acts=True)

                    row["fused_route_ms"] = time_ms(
                        lambda i: flash_ff_silu_q4(*ws[i % copies], x,
                                                   quantize_acts=True), 48)
                    row["unfused_ms"] = time_ms(unfused, 48)
                if plain:
                    row["plain_ms"] = time_ms(lambda i, xv=x if acts == "f32"
                                              else xr: _ff_silu_ref(
                                                  *ws[i % copies], xv,
                                                  quantize_acts=False), 6)
                rows.append(row)
        del ws, wb
        torch.cuda.empty_cache()
    emit({"mlp_fused_silu_timing": rows})
    if counts is None:
        return rows
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    r7 = [r for r in rows if r["config"] == "7B"]
    r1 = next(r for r in r7 if r["rows"] == 1 and r["acts"] == "f32")
    rq = next(r for r in r7 if r["rows"] == 1 and r["acts"] == "q8")
    r16 = next(r for r in r7 if r["rows"] == PROMPT_LEN and r["acts"] == "q8")
    b1 = {"name": "mlp_fused_silu_q4", "route": "cuda",
          "source": "ggmlsharp_tpu_torch/csrc/mlp_fused_silu_q4.cu",
          "replaces": "ggmlsharp_tpu/kernels/mlp_fused.py:268",
          "launches": counts["mlp_fused_silu_q4"],
          **{key: r1[key] for key in keys},
          "fused_route_ms": rq["fused_route_ms"],
          "unfused_ms": rq["unfused_ms"],
          "one_row_ms": {r["config"]: r["ms"] for r in rows
                         if r["rows"] == 1 and r["acts"] == "f32"},
          "unit": "one Llama-7B MLP call at 1 row (a decode step): E 4096, "
                  "F 11008, cold L2; library = two bf16 torch.matmuls + "
                  "F.silu; fused_route_ms / unfused_ms: path d2's fused "
                  "call and path a's unfused matmul_q4_0 + silu * u + "
                  "matmul_q4_0, each with its Q8_0 round trip"}
    mma = {"name": "mlp_fused_silu_q4_mma", "route": "cuda",
           "source": "ggmlsharp_tpu_torch/csrc/mlp_fused_silu_q4.cu",
           "replaces": "ggmlsharp_tpu/kernels/mlp_fused.py:268",
           "launches": counts["mlp_fused_silu_q4_mma"],
           **{key: r16[key] for key in keys},
           "rows_ms": {f"{r['rows']} {r['acts']}": r["ms"] for r in r7},
           "rows_library_ms": {f"{r['rows']} {r['acts']}": r["library_ms"]
                               for r in r7},
           "rows_bound_ms": {f"{r['rows']} {r['acts']}": r["bound_ms"]
                             for r in r7},
           "unit": "one Llama-7B MLP call at 16 rows (the prompt of paths d1, "
                   "d2), Q8_0 activations, cold L2 (the multi-row instance, "
                   "csrc/dq_mma.cuh: split, gate/up, merge_gate, down, "
                   "merge); library = two bf16 torch.matmuls + F.silu"}
    return rows, b1, mma


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


def time_llama_layer(dev, gen, plain=True):
    """Cold-L2 kernel and plain times of one decode step's block call at
    Llama-7B's block, bf16 cache: T 256 at npast 32 (path d's steps run 16 to
    47) and T 2048 at npast 2047; each call a different block's weights, as a
    decode step walks the layers (a block's 113.8 MB exceed L2 alone). cos
    and sin are made before timing, as forward makes them once a step. No
    single PyTorch call computes a whole block: library_ms is null. Also,
    where the source has it, the build with LAYER_NO_MATVEC (no weight
    streamed, no product: the barriers, norms, rope, attention and merge
    alone), no_matvec_ms."""
    import torch

    from ggmlsharp_tpu_torch import kernels
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
        step = lambda i: llama_layer_step(blocks[i % copies], x, kc[:T],
                                          vc[:T], np_t, cfg, rope)
        ms = time_ms(step, 24)
        row = {"T": T, "npast": npast, "ms": ms, "library_ms": None,
               "bound_ms": bound, "bound_by": by, "roofline_share": bound / ms,
               "cold_copies": copies}
        if plain:
            row["plain_ms"] = time_ms(lambda i: _layer_ref(
                blocks[i % copies], x, kc[:T], vc[:T], np_t, cfg, rope), 6)
        if "LAYER_NO_MATVEC" in open(os.path.join(
                kernels._build.CSRC, "llama_layer.cu")).read():
            kernels.set_defines("llama_layer", LAYER_NO_MATVEC)
            try:
                row["no_matvec_ms"] = time_ms(step, 24)
            finally:
                kernels.set_defines("llama_layer", ())
        rows.append(row)
    del blocks
    torch.cuda.empty_cache()
    emit({"llama_layer_timing": rows})
    r = rows[0]
    return {"name": "llama_layer", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/llama_layer.cu",
            "replaces": "ggmlsharp_tpu/kernels/llama_layer.py:213",
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by") if key in r},
            "npast_2047": rows[1],
            "no_matvec_ms": r.get("no_matvec_ms"),
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
    """Kernel A's two instances vs plain for its seven formats
    (check_weight_rows), then rows_independent_of_b for each format;
    raises if a format's rows depend on b."""
    worst, same = {}, {}
    for fmt in A_FORMATS:
        worst[fmt] = check_weight_rows(dev, gen, fmt, "matmul_q_check")
        same[fmt] = rows_independent_of_b(dev, gen, fmt)
    emit({"matmul_q_rows_vs_b": same})
    if not all(r["ok"] for r in same.values()):
        raise SystemExit(f"a matmul_q row's result depends on b: {same}")
    return worst


def check_int_dot(dev, gen):
    """Kernel B vs its plain _int_dot_ref for its five formats at the 7B
    shapes of a decode step's matmuls (b = 1) and at RAGGED and SHORT_K (N
    4099: a multiple of no CTA's rows; K/32 344 and 129: a multiple of no
    warp step of 32 blocks), the same quantized activations on both sides.
    The block sums are exact integers on both; tolerance: f32 summation
    order over blocks, 1e-5 of sum_k |x_k| (|q d| + |m|)_nk with x the Q8
    activations."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import (_int_dot_ref,
                                                      int_dot_acts,
                                                      int_dot_launch)

    worst, rows = {}, []
    for fmt in B_FORMATS:
        for name, n, k, _ in Q4_SHAPES[:4] + [RAGGED, SHORT_K]:  # the LM head keeps f32 x
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


def wq_bound_ms(b, n, k, wbytes, x_bytes, q8_acts, planes=3):
    """Bytes: the packed weight as the kernel reads it, the activations as
    the timed call takes them (``x_bytes``: f32 x, b*k*4, or the Q8 int8
    values and their block scales) and y, once each. Operations, the least
    any implementation needs on this card: after the Q8 round trip the
    operands are int8 x int4..int6 values, which the int8 tensor cores
    multiply exactly (2*b*n*k at INT8_OP_S); the LM head's x stays f32,
    which bf16 tensor cores multiply exactly as three products a term (x in
    three bf16 planes: 6*b*n*k at BF16_FLOP_S), or, ``planes`` 1 (mm_dot
    "bf16": x rounded), one."""
    t_bytes = (wbytes + x_bytes + b * n * 4) / HBM_BYTES_S
    t_ops = (2 * b * n * k / INT8_OP_S if q8_acts
             else 2 * planes * b * n * k / BF16_FLOP_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_matmul_q(dev, gen, counts):
    """Phase 5 of kernel A: Q4_K and Q6_K at every 7B shape, b in
    PHASE5_B; the other formats at w_gate_up, b 1 and 16. The kernels-line
    rows of its b = 1 instance (one decode token of path e1, Q4_K: its 129
    b = 1 launches) and its multi-row instance (path e1's prompt forward:
    129 launches at b = 16)."""
    rows = []
    for fmt in A_FORMATS:
        if fmt in E_FORMATS:
            rows += time_weight_rows(dev, gen, fmt, Q4_SHAPES, PHASE5_B)
        else:
            rows += time_weight_rows(dev, gen, fmt, Q4_SHAPES[2:3], (1, 16))
    emit({"matmul_q_timing": rows})
    gu = {b: {r["format"]: r["ms"] for r in rows if r["shape"] == "w_gate_up"
              and r["b"] == b and r["acts"] == "q8"} for b in (1, 16)}
    b1 = {"name": "matmul_q", "route": "cuda",
          "source": "ggmlsharp_tpu_torch/csrc/matmul_q.cu",
          "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:377 (and :199, "
                      ":737)",
          "launches": counts["matmul_q"], **forward_sum(rows, "Q4_K", 1),
          "q6_k_token": forward_sum(rows, "Q6_K", 1),
          "w_gate_up_b1_ms": gu[1],
          "unit": "one decode token of path e1 (Q4_K): the 129 b=1 "
                  "launches, cold L2; library = bf16 torch.matmul"}
    mma = {"name": "matmul_q_mma", "route": "cuda",
           "source": "ggmlsharp_tpu_torch/csrc/matmul_q.cu",
           "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:377 (and :199, "
                       ":737)",
           "launches": counts["matmul_q_mma"],
           **forward_sum(rows, "Q4_K", 16),
           "q6_k_prompt": forward_sum(rows, "Q6_K", 16),
           "w_gate_up_b16_ms": gu[16],
           "unit": "one prompt forward of path e1 (Q4_K): the 129 launches "
                   "at b=16 (the multi-row instance, csrc/dq_mma.cuh; Q8_K "
                   "activations but at the LM head), cold L2; library = bf16 "
                   "torch.matmul"}
    return b1, mma


def int_dot_bound_ms(n, k, wbytes, m_term):
    """Bytes: the packed weight, the Q8 activations (int8 values, their f32
    scales and, for Q4_1/Q5_1, the f32 s) and y, once each. Operations:
    int8 x int8 products on the int8 tensor cores' rate (the least any
    implementation needs on this card)."""
    act_bytes = k + k // 32 * 4 * (2 if m_term else 1)
    t_bytes = (wbytes + act_bytes + n * 4) / HBM_BYTES_S
    t_ops = 2 * n * k / INT8_OP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_int_dot(dev, gen, counts, plain=True):
    """Cold-L2 kernel B, plain and library (bf16 torch.matmul against the
    weight dequantized to bf16) times at the four 7B decode shapes (b = 1),
    for each of its formats; the activations quantized once before timing,
    as a call quantizes them before its launch. counts None: no kernels-line
    row (--matmul-timing); plain False: no plain or library time."""
    import torch

    from ggmlsharp_tpu_torch.kernels.matmul_q import (_int_dot_ref,
                                                      int_dot_acts,
                                                      int_dot_launch)
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    rows = []
    for fmt in B_FORMATS:
        for shape, n, k, _ in Q4_SHAPES[:4]:
            w0 = random_weight(fmt, n, k, gen, dev)
            wbytes = w0.nbytes()
            copies = max(2, -(-4 * L2_BYTES // wbytes))
            ws = [w0] + [random_weight(fmt, n, k, gen, dev)
                         for _ in range(copies - 1)]
            x = torch.randn(k, generator=gen, device=dev)
            xq, da, xs = int_dot_acts(w0, x)
            kern = time_ms(lambda i: int_dot_launch(ws[i % copies], xq, da,
                                                    xs), max(50, copies))
            bound, by = int_dot_bound_ms(n, k, wbytes, xs is not None)
            row = {"format": fmt, "shape": shape, "n": n, "k": k,
                   "weight_bytes": wbytes, "ms": kern, "bound_ms": bound,
                   "bound_by": by, "roofline_share": bound / kern,
                   "cold_copies": copies}
            if plain:
                wb = [dequantize(w).to(torch.bfloat16) for w in ws]
                xb = x.to(torch.bfloat16)[None]
                row["plain_ms"] = time_ms(
                    lambda i: _int_dot_ref(ws[i % copies], xq, da, xs), 8)
                row["library_ms"] = time_ms(
                    lambda i: torch.matmul(xb, wb[i % copies].T),
                    max(50, copies))
                del wb
            rows.append(row)
            del ws
            torch.cuda.empty_cache()
    emit({"int_dot_timing": rows})
    if counts is None:
        return rows
    r = next(r for r in rows
             if r["format"] == "Q4_0" and r["shape"] == "w_gate_up")
    return {"name": "matmul_int_dot", "route": "cuda",
            "source": "ggmlsharp_tpu_torch/csrc/matmul_int_dot.cu",
            "replaces": "ggmlsharp_tpu/kernels/matmul_q.py:803",
            "launches": counts["matmul_int_dot"],
            **{key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            "shapes_ms": {f: {x["shape"]: x["ms"] for x in rows
                              if x["format"] == f} for f in B_FORMATS},
            "shapes_bound_ms": {f: {x["shape"]: x["bound_ms"] for x in rows
                                    if x["format"] == f}
                                for f in B_FORMATS},
            "unit": "one w_gate_up launch (22016 x 4096, b=1) of Q4_0, cold "
                    "L2; library = bf16 torch.matmul; shapes_ms: every "
                    "format at the four 7B decode shapes"}


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
            # the prompt's matmuls at 16 rows: the multi-row instance
            prompt_ = dq_launches(kern, 4 * L + 1, 0)
            if route == "f1":
                want = {**prompt_, "flash_attn": L}
                want[kern] += (4 * L + 1) * F_NEW
            else:
                os.environ["GGML_TPU_INT_DOT"] = "1"
                want = {**prompt_, "flash_attn": L,
                        "matmul_int_dot": 4 * L * F_NEW}
                want[kern] += F_NEW  # the LM head's x stays f32
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
    # n_past -5: queries 0-4 see no key, and give 0
    ("unc_causal_masked_rows_f32", "uncached", (2, 4), 24, 24, 64, True, -5,
     "f32", 0.0),
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


def train_form(form, loss, params):
    """TRAIN_STEPS Adam steps of ``loss`` from ``params`` through
    optim.opt_fn in ``form``: "captured" (the default: step 1 the eager
    warm-up, step 2 the capture and its replay, 3.. replays) or "eager"
    (captured.disabled()). Host seconds a step (synchronised in the
    callback, after opt_adam's read of f), the median of steps 2-4 and of
    the replays 3-4, the launch counters and captured.COUNTS of the run,
    its peak memory, then a profiler window of two more steps (3-4 of a
    second run) for the device time a step and the idle share."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.optim import opt_fn

    stamps, losses = [], []

    def on_step(it, f):  # opt_adam has read f back: the step is done
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    captured.reset_counts()
    t0 = time.perf_counter()
    with captured.disabled() if form == "eager" else contextlib.nullcontext():
        x, fx, res, iters = opt_fn(loss, params, adam_params(TRAIN_STEPS),
                                   on_step)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    cap = dict(captured.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    med = statistics.median(step_s[1:])
    prof = profile_adam_window(loss, params, 3, 2, form == "eager")
    dev_ms = prof["device_ms_per_step"]
    return {"form": form, "x": x, "iters": iters, "result": res.name,
            "losses": losses, "step_s": step_s,
            "step_ms_median_2_4": med * 1e3,
            "step_ms_median_3_4": statistics.median(step_s[2:]) * 1e3,
            "tokens_per_s": TRAIN_B * TRAIN_S / med,
            "launches": counts, "captures": cap["captures"],
            "replays": cap["replays"], "capture_s": cap["capture_s"],
            "peak": peak, "profile": prof,
            "device_idle_share": (1.0 - dev_ms / (med * 1e3)
                                  if isinstance(dev_ms, float)
                                  else "not measured")}


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
    0.05. Then TRAIN_STEPS Adam steps through optim.opt_fn (AdamParams'
    alpha 1e-3, stopping rules off) in each form (train_form): eager
    (captured.disabled()), then captured (step 1 the warm-up, one capture,
    replays), from the same parameters, the launch counters reset just
    before and read just after: one flash launch a layer a step in both.
    The captured losses must be the eager form's within 1e-3 relative (the
    kernel-versus-plain bar; the same operations run in both), one capture
    and TRAIN_STEPS - 1 replays; the loss at the final parameters must be
    below the first; the median step time of steps 2-4 gives tokens/s and
    the share of the bf16 dense peak at 6 FLOPs a parameter a token; peak
    memory counts what the path allocates above what earlier paths keep
    resident. Each form's torch.profiler window of two more steps gives
    device time, launches and the idle share."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.models.common import lm_loss
    from ggmlsharp_tpu_torch.optim import value_and_grad
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

    forms = {form: train_form(form, loss, params) for form in
             ("eager", "captured")}
    cap, eag = forms["captured"], forms["eager"]
    del eag["x"]
    eag["bf16_peak_share"] = train_step_flops(
        n_params, eag["tokens_per_s"]) / BF16_FLOP_S
    x, counts, losses, med = cap["x"], cap["launches"], cap["losses"], \
        cap["step_ms_median_2_4"] / 1e3
    with torch.no_grad():
        f_end = float(loss(x))
    tok_s = TRAIN_B * TRAIN_S / med
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn": cfg.n_layer * TRAIN_STEPS}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, eag["losses"]))
    out = {"config": f"GPT-2 E {cfg.n_embd} x {cfg.n_layer} layers, bf16",
           "card": smi, "n_params": n_params,
           "batch": TRAIN_B, "seq": TRAIN_S, "steps": cap["iters"],
           "result": cap["result"], "losses": losses, "loss_after": f_end,
           "step_s": cap["step_s"], "step_ms_median_2_4": med * 1e3,
           "tokens_per_s": tok_s,
           "model_flop_s": train_step_flops(n_params, TRAIN_B * TRAIN_S) / med,
           "bf16_peak_share": train_step_flops(n_params, tok_s) / BF16_FLOP_S,
           "peak_mem_gb": (cap["peak"] - base) / 1e9, "launches": counts,
           "profile": cap["profile"],
           "device_idle_share": cap["device_idle_share"],
           "capture_s": cap["capture_s"], "captures": cap["captures"],
           "replays": cap["replays"],
           "eager": {k: v for k, v in eag.items() if k != "peak"}
           | {"peak_mem_gb": (eag["peak"] - base) / 1e9},
           "loss_rel_err_vs_eager": loss_err, "loss_bar_vs_eager": 1e-3,
           "expected_launches": want,
           "flash_launches_per_step": counts["flash_attn"] / TRAIN_STEPS}
    emit({"train_path": out})
    if counts != want or eag["launches"] != want:
        raise SystemExit(f"path g launch counts {counts} (eager "
                         f"{eag['launches']}) != {want}")
    if (cap["captures"], cap["replays"]) != (1, TRAIN_STEPS - 1) \
            or eag["captures"] or not loss_err <= 1e-3:
        raise SystemExit(f"path g: the captured steps differ from the eager "
                         f"form's: {out}")
    if cap["iters"] != TRAIN_STEPS or not f_end < losses[0] or f_end != f_end:
        raise SystemExit(f"path g: the loss did not fall: {out}")
    return out, counts, (x, loss, cfg.n_layer)


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


@contextlib.contextmanager
def spy(mod, name, out, sync=False):
    """mod.name wrapped for the block: each call appends (its return value,
    its seconds) to ``out``; sync=True brackets the call with
    torch.cuda.synchronize() so that the seconds hold its device work."""
    import torch

    from ggmlsharp_tpu_torch.models import captured

    orig = getattr(mod, name)

    def wrapped(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        out.append((r, time.perf_counter() - t0))
        return r

    setattr(mod, name, wrapped)
    try:
        with captured.disabled():  # a replay would not call the spy
            yield
    finally:
        setattr(mod, name, orig)


def test3_fit(form, F, lab, smi):
    """Test3 built through the ggml_* API (a context on the card) and fitted
    by L-BFGS: form "jit" through ggml_opt, which takes opt_lbfgs_jit (one
    probe captured into a CUDA graph, replayed in batches) by opt_lbfgs's
    dispatch; form "host" through opt() with a per-iteration callback,
    which takes opt_lbfgs_host. Returns (the fitted weights, a record)."""
    import torch

    from ggmlsharp_tpu_torch import GType, compat
    from ggmlsharp_tpu_torch.graph import builders as B, set_data
    from ggmlsharp_tpu_torch.optim import lbfgs, opt

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
    calls, caps = [], []
    lbfgs.reset_counts()
    with spy(lbfgs, f"opt_lbfgs_{form}", calls), \
            spy(lbfgs, "_capture", caps, sync=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if form == "jit":
            res = compat.ggml_opt(ctx, prm, f)
        else:
            res, _ = opt(f, prm, callback=lambda it, fx: None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if len(calls) != 1:
        raise SystemExit(f"path h1: the {form} fit did not go through "
                         f"opt_lbfgs_{form} once ({len(calls)} calls)")
    w_true = torch.where(torch.arange(TEST3_NF, device=w.data.device)
                         < TEST3_NF // 2, 1.0, -1.0)
    cap_s = sum(t for _, t in caps)
    return w.data, {
        "form": f"opt_lbfgs_{form}", "card": smi, "result": res.name,
        "iterations": calls[0][0][3], **lbfgs.COUNTS,
        "fit_seconds": secs - cap_s, "capture_seconds": cap_s,
        "max_abs_weight_err": float((w.data - w_true).abs().max()),
        "device": str(w.data.device)}


def rosen(p):
    return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] * p[0]) ** 2


def lbfgs_rosenbrock(dev):
    """Rosenbrock from (-1.2, 1) under each line search: opt_lbfgs_jit on
    the card (captured) held against the same function's eager run on the
    CPU: the same result code and iterations, x within 1e-4. Each card run
    is timed (capture apart) beside opt_lbfgs_host's on the card."""
    import torch

    from ggmlsharp_tpu_torch.optim import (LineSearch, OptType, lbfgs,
                                           opt_default_params,
                                           value_and_grad)

    out = {}
    for ls in ("ARMIJO", "WOLFE", "STRONG_WOLFE"):
        prm = opt_default_params(OptType.LBFGS)
        prm.lbfgs.n_iter = 200
        prm.lbfgs.linesearch = LineSearch[ls]
        runs = {}
        for where, fit in ((dev, lbfgs.opt_lbfgs_jit),
                           (torch.device("cpu"), lbfgs.opt_lbfgs_jit),
                           (dev, lbfgs.opt_lbfgs_host)):
            lbfgs.reset_counts()
            caps = []
            with spy(lbfgs, "_capture", caps, sync=where.type == "cuda"):
                if where.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, _, res, it = fit(value_and_grad(rosen),
                                    torch.tensor([-1.2, 1.0], device=where),
                                    prm)
                secs = time.perf_counter() - t0
            cap_s = sum(t for _, t in caps)
            runs[where.type, fit.__name__] = (
                x.cpu(), res.name, it,
                {**lbfgs.COUNTS, "fit_seconds": secs - cap_s,
                 "capture_seconds": cap_s})
        (xc, rc, ic, cc), (xh, rh, ih, _), (_, rd, ihc, hc) = runs.values()
        out[ls] = {"result": rc, "iterations": ic, **cc,
                   "cpu_result": rh, "cpu_iterations": ih,
                   "max_abs_x_diff": float((xc - xh).abs().max()),
                   "host_form_on_card": {"result": rd, "iterations": ihc,
                                         **hc}}
        if rc != rh or ic != ih or out[ls]["max_abs_x_diff"] > 1e-4 \
                or cc["captures"] != 1:
            raise SystemExit(f"path h1: Rosenbrock {ls} on the card differs "
                             f"from the CPU run: {out[ls]}")
    return out


def lbfgs_capture_failure(dev):
    """A fun_vg that reads f back to the host cannot be captured:
    opt_lbfgs_jit raises RuntimeError naming the cause, and the host loop is
    never called in its place."""
    import torch

    from ggmlsharp_tpu_torch.optim import (OptType, lbfgs,
                                           opt_default_params,
                                           value_and_grad)

    def synced(v):
        f = ((v - 1.0) ** 2).sum()
        return f * 2.0 if float(f.detach()) < 0 else f

    host_calls = []
    with spy(lbfgs, "opt_lbfgs_host", host_calls):
        try:
            lbfgs.opt_lbfgs_jit(value_and_grad(synced),
                                torch.zeros(8, device=dev),
                                opt_default_params(OptType.LBFGS))
        except RuntimeError as e:
            msg = str(e)
        else:
            raise SystemExit("path h1: a fun_vg with a host sync was "
                             "captured without error")
    if "could not be captured" not in msg or host_calls:
        raise SystemExit(f"path h1: the capture failure was not reported as "
                         f"one, or fell back to the host loop: {msg}")
    return msg.split("Cause: ", 1)[-1]


def run_graph_test3(dev, smi):
    """Path h1, Test3, the reference's largest workload: the 4096 x 256
    L2-regularised linear classifier through the ggml_* API, fitted by
    L-BFGS in both forms (test3_fit) on the same data. Each form: every
    weight within 1e-2 of +-1, result OK or DID_NOT_CONVERGE; the two forms:
    the same result, weights within 1e-3; the jit form replayed its graph
    and read back at most ceil(evaluations / K) + 2 times. Then Rosenbrock
    on the card against the CPU, and a capture that must fail."""
    import math

    from ggmlsharp_tpu_torch.optim import lbfgs

    F, lab = test3_data(TEST3_NP, TEST3_NF)
    wj, jit = test3_fit("jit", F, lab, smi)
    wh, host = test3_fit("host", F, lab, smi)
    k = lbfgs.PROBES_PER_READBACK
    h1 = {"workload": "Test3 4096 x 256 L-BFGS via ggml_opt", "card": smi,
          "jit": jit, "host": host, "probes_per_readback": k,
          "readback_bar": math.ceil(jit["evaluations"] / k) + 2,
          "max_abs_weight_diff_jit_host": float((wj - wh).abs().max()),
          "bar": 1e-2}
    for form in (jit, host):
        if form["max_abs_weight_err"] > 1e-2 \
                or not form["device"].startswith(dev.type) \
                or form["result"] not in ("OK", "DID_NOT_CONVERGE"):
            raise SystemExit(f"path h1: Test3 missed its criterion: {h1}")
    if jit["result"] != host["result"] \
            or h1["max_abs_weight_diff_jit_host"] > 1e-3:
        raise SystemExit(f"path h1: the two L-BFGS forms disagree: {h1}")
    if jit["replays"] < 1 or jit["captures"] != 1 \
            or jit["readbacks"] > h1["readback_bar"]:
        raise SystemExit(f"path h1: the jit form did not run as one captured "
                         f"graph within its readbacks: {h1}")
    h1["rosenbrock"] = lbfgs_rosenbrock(dev)
    h1["capture_failure"] = lbfgs_capture_failure(dev)
    emit({"graph_test3": h1})
    for form in (jit, host):
        log(f"[4/6] h1. Test3 {form['form']} ({smi}): {form['result']} in "
            f"{form['iterations']} iterations, {form['evaluations']} "
            f"evaluations, {form['readbacks']} host readbacks, "
            f"{form['replays']} graph replays; fit "
            f"{form['fit_seconds']:.3f} s, capture "
            f"{form['capture_seconds']:.3f} s; max weight err "
            f"{form['max_abs_weight_err']:.3g}")
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
    add the dense backward's own). The kernel route's compute runs first
    in the eager form (captured.disabled()), then captured (one graph),
    held to the eager form at the same bars with the same launches; then
    the token leaf gets new tokens (set_data) and the graph computes again:
    one replay, no capture. Then GRAPH_STEPS Adam steps of opt() (stopping
    rules off) in both forms from the same weights, the counters reset just
    before: the uncached entry launches once a layer a forward, and the
    backward graph's generic VJPs of each flash_attn node rerun its forward
    once a source (3 a layer); the captured losses within 1e-4 relative of
    the eager form's, one capture and GRAPH_STEPS - 1 replays."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.graph import (build_backward, build_forward,
                                           builders as B, leaf, set_data,
                                           set_f32)
    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.optim import opt

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
        forms = {}
        for form in ("captured",) if plain else ("eager", "captured"):
            forms[form] = graph_compute_form(form, gb, obj, ws)
        runs[plain] = forms["captured"] | {
            "obj": obj, "ws": ws, "tok": tok, "gb": gb,
            "eager": forms.get("eager"), "n_nodes": len(gb.nodes)}
    k, p = runs[False], runs[True]
    rel = [float((a - b).norm() / b.norm()) for a, b in
           zip(k["grads"], p["grads"])]
    e = k["eager"]
    rel_e = [float((a - b).norm() / b.norm()) for a, b in
             zip(k["grads"], e["grads"])]
    # the same compute after set_data on the token leaf: a replay
    toks2 = torch.randint(0, V, (S,), generator=gen, device=dev,
                          dtype=torch.int32)
    set_data(k["tok"], toks2)
    again = graph_compute_form("captured", k["gb"], k["obj"], k["ws"])
    set_data(k["tok"], toks)
    computed = [n.data for n in k["gb"].nodes if n.op != "none"]
    inputs = [n.data for n in k["gb"].nodes + k["gb"].leafs
              if n.op == "none"]
    want_bwd = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn_uncached": 4 * GRAPH_LAYERS}
    cmp = {"loss": k["f"], "loss_plain": p["f"],
           "loss_rel_err": abs(k["f"] - p["f"]) / abs(p["f"]),
           "grad_rel_l2_max": max(rel), "n_nodes": k["n_nodes"],
           "backward_graph_seconds": k["seconds"],
           "backward_graph_seconds_eager": e["seconds"],
           "captures": k["captures"], "capture_s": k["capture_s"],
           "loss_rel_err_vs_eager": abs(k["f"] - e["f"]) / abs(e["f"]),
           "grad_rel_l2_max_vs_eager": max(rel_e),
           "launches": k["launches"], "eager_launches": e["launches"],
           "expected_launches": want_bwd,
           "plain_launches": {n: c for n, c in p["launches"].items() if c},
           "second_compute": {"seconds": again["seconds"],
                              "captures": again["captures"],
                              "replays": again["replays"],
                              "loss": again["f"],
                              "launches_equal": again["launches"]
                              == want_bwd},
           "output_copy_bytes": sum(t.numel() * t.element_size()
                                    for t in computed),
           "input_copy_bytes": sum(t.numel() * t.element_size()
                                   for t in inputs)}
    emit({"graph_decoder_compare": cmp})
    if cmp["loss_rel_err"] > 1e-4 or max(rel) > 1e-3 \
            or k["launches"] != want_bwd or any(p["launches"].values()):
        raise SystemExit(f"path h2: the graph disagrees or launched wrong: "
                         f"{cmp}")
    if cmp["loss_rel_err_vs_eager"] > 1e-4 or max(rel_e) > 1e-3 \
            or e["launches"] != want_bwd or k["captures"] != 1 \
            or (again["captures"], again["replays"]) != (0, 1) \
            or again["launches"] != want_bwd or again["f"] == k["f"]:
        raise SystemExit(f"path h2: the captured compute differs from the "
                         f"eager form's or captured again: {cmp}")
    prm = adam_params(GRAPH_STEPS)
    start = [w.data for w in k["ws"]]
    opt_runs = {}
    for form in ("eager", "captured"):
        for w, d in zip(k["ws"], start):
            w.data = d
        losses = []
        torch.cuda.synchronize()
        kernels.reset_launches()
        captured.reset_counts()
        t0 = time.perf_counter()
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            opt(k["obj"], prm, lambda it, fv: losses.append(fv))
        torch.cuda.synchronize()
        opt_runs[form] = {"losses": losses,
                          "seconds": time.perf_counter() - t0,
                          "launches": dict(kernels.LAUNCHES),
                          **{c: captured.COUNTS[c] for c in
                             ("captures", "replays", "capture_s")}}
    oc, oe = opt_runs["captured"], opt_runs["eager"]
    losses, counts = oc["losses"], oc["launches"]
    gf = build_forward(k["obj"])
    gf.compute()
    f_end = float(k["obj"].data[0])
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn_uncached": GRAPH_LAYERS * GRAPH_STEPS}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, oe["losses"]))
    h2 = {"decoder": f"E {E}, {H} heads, S {S}, {GRAPH_LAYERS} layers, V {V}",
          "card": smi, "steps": GRAPH_STEPS, "losses": losses,
          "loss_after": f_end, "seconds": oc["seconds"],
          "captures": oc["captures"], "replays": oc["replays"],
          "capture_s": oc["capture_s"], "launches": counts,
          "eager": oe, "loss_rel_err_vs_eager": loss_err,
          "expected_launches": want}
    emit({"graph_decoder_train": h2})
    if counts != want or oe["launches"] != want or not f_end < losses[0]:
        raise SystemExit(f"path h2: opt() failed: {h2}")
    if loss_err > 1e-4 or (oc["captures"], oc["replays"]) != (
            1, GRAPH_STEPS - 1):
        raise SystemExit(f"path h2: opt()'s captured steps differ from the "
                         f"eager form's: {h2}")
    total = {n: k["launches"][n] + counts[n] for n in counts}
    return cmp, h2, total


def graph_compute_form(form, gb, obj, ws):
    """gb.compute() in ``form`` ("eager": captured.disabled()), the
    counters reset just before: the loss, the weights' gradients, the
    launches, captured.COUNTS and the host seconds."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured

    torch.cuda.synchronize()
    kernels.reset_launches()
    captured.reset_counts()
    t0 = time.perf_counter()
    with captured.disabled() if form == "eager" else contextlib.nullcontext():
        gb.compute()
    torch.cuda.synchronize()
    return {"f": float(obj.data[0]), "grads": [x.grad.data for x in ws],
            "launches": dict(kernels.LAUNCHES),
            "seconds": time.perf_counter() - t0,
            **{c: captured.COUNTS[c] for c in
               ("captures", "replays", "capture_s")}}


def run_gpt2_int8_serving(gcfg, gparams):
    """GPT-2 124M (path c's Q8_0 weights) behind serving.Engine with an INT8
    cache, which for GPT-2 is head-major: SERVE_G_SLOTS slots, SERVE_G_REQS
    requests of SERVE_G_PLEN + SERVE_G_NEW tokens, the counters reset just
    before (captured, then eager: the two must give the same tokens and
    launches); then the same engine with plain=True. Weight-only
    (GGML_TPU_QUANT_ACTS=0), so the two differ in f32 summation order alone
    (the INT8 rows round the same values); each request's tokens must be the
    plain engine's."""
    import functools

    import numpy as np
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured, gpt2
    from ggmlsharp_tpu_torch.serving import Engine, Request

    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, gcfg.n_vocab, size=SERVE_G_PLEN).tolist()
               for _ in range(SERVE_G_REQS)]
    outs, counts, layout = {}, {}, None
    os.environ["GGML_TPU_QUANT_ACTS"] = "0"
    try:
        # the kernel engine captured (the default), then eager; the plain one
        for plain, eager in ((False, False), (False, True), (True, False)):
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
            with captured.disabled() if eager else contextlib.nullcontext():
                res = {r.id: r for r in eng.run()}
            torch.cuda.synchronize()
            if not plain:
                counts[eager] = dict(kernels.LAUNCHES)
            if not (plain or eager):
                secs = time.perf_counter() - t0
                st = eng.stats()
            outs[plain, eager] = res
            del eng
    finally:
        os.environ.pop("GGML_TPU_QUANT_ACTS")
    eager_same = all(outs[False, False][i].out_tokens
                     == outs[False, True][i].out_tokens
                     for i in range(SERVE_G_REQS)) and counts[False] \
        == counts[True]
    outs = {plain: outs[plain, False] for plain in (False, True)}
    counts = counts[False]
    same = [outs[False][i].out_tokens == outs[True][i].out_tokens
            for i in range(SERVE_G_REQS)]
    out = {"model": "GPT2_124M Q8_0", "slots": SERVE_G_SLOTS,
           "requests": SERVE_G_REQS, "cache_int8_flat_shape": layout,
           "seconds": secs, "tokens_per_s": SERVE_G_REQS * SERVE_G_NEW / secs,
           "ticks": st["ticks"], "launches": counts,
           "tokens_equal_plain": same,
           "tokens_and_launches_equal_eager_form": eager_same,
           "first_tokens": [outs[False][i].out_tokens[:4] for i in range(2)]}
    emit({"gpt2_int8_serving": out})
    bad = [i for i in range(SERVE_G_REQS)
           if outs[False][i].error or len(outs[False][i].out_tokens)
           != SERVE_G_NEW]
    if not (layout[0] and not layout[1]) or bad or not all(same) \
            or not eager_same \
            or counts["flash_attn"] == 0 or counts["attn_decode"] != 0 \
            or counts["mlp_fused_q8_mma"] == 0:
        raise SystemExit(f"GPT-2 INT8 serving failed: {out}")
    return out, counts


def flash2_bound_ms(B, Hq, Hkv, S, T, D, in_bytes, out_bytes, npast=0,
                    causal=True, kv_bytes=None):
    """Bytes of q (in_bytes an element), out (out_bytes) and the K/V rows the
    queries keep (kv_bytes an element, default in_bytes), once each; 4 * D
    operations a kept (query, key) pair at the bf16 tensor-core rate (16-bit
    inputs) or the f32 rate."""
    kv_bytes = in_bytes if kv_bytes is None else kv_bytes
    kept = min(T, S + npast) if causal else T
    bytes_ = B * Hq * S * D * (in_bytes + out_bytes) \
        + 2 * B * Hkv * kept * D * kv_bytes
    pairs = sum(min(T, s + npast + 1) for s in range(S)) if causal else S * T
    flops = 4 * B * Hq * pairs * D
    rate = BF16_FLOP_S if in_bytes == kv_bytes == 2 else F32_FLOP_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash2_bwd_bound_ms(B, H, S, D, in_bytes, out_bytes, grad_bytes):
    """The causal backward at S = T, npast 0: bytes of q, k, v (in_bytes an
    element), o (out_bytes), do (grad_bytes) read once and dq, dk, dv
    (in_bytes) written once; operations 10 D a kept (query, key) pair (S =
    q k^T again, dv = p^T do, dp = do v^T, dq = ds k, dk = ds^T q) at the
    bf16 tensor-core rate."""
    elems = B * H * S * D
    bytes_ = elems * (6 * in_bytes + out_bytes + grad_bytes)
    flops = 10 * B * H * (S * (S + 1) // 2) * D
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / BF16_FLOP_S
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
    res["bwd_bound_ms"], res["bwd_bound_by"] = flash2_bwd_bound_ms(
        B, H, S, D, 2, 4, 4)  # bf16 q, k, v, grads; the entry's f32 o; f32 do
    emit({"flash_train_timing": res})
    return res


# kernel 2 at every shape a path runs it: (label, entry, B, Hq, Hkv, S, T,
# T allocated, D, npast, q dtype, kv dtype, softcap, cold L2). Path a's
# prefill reads the rows it just wrote (warm); the others rotate copies.
FLASH_TIMING = [
    ("7b_prefill", "cached", 1, 32, 32, 16, 256, 2048, 128, 0, "f32", "bf16",
     0.0, False),
    ("serve_prefill", "cached", SLOTS, 32, 32, 16, 16, 16, 128, 0, "f32",
     "f32", 0.0, True),
    ("gpt2_124m_prefill", "cached", 1, 12, 12, 16, 16, 16, 64, 0, "f32",
     "f32", 0.0, True),
    ("gpt2_774m_prefill", "cached", 1, 20, 20, 16, 16, 16, 64, 0, "f32",
     "f32", 0.0, True),
    ("train_g_cached", "cached", TRAIN_B, 12, 12, TRAIN_S, TRAIN_S, TRAIN_S,
     64, 0, "bf16", "bf16", 0.0, True),
    ("train_g_softcap30", "cached", TRAIN_B, 12, 12, TRAIN_S, TRAIN_S,
     TRAIN_S, 64, 0, "bf16", "bf16", 30.0, True),
    ("train_g_uncached", "uncached", TRAIN_B, 12, 12, TRAIN_S, TRAIN_S,
     TRAIN_S, 64, 0, "bf16", "bf16", 0.0, True),
    ("graph_h2_uncached", "uncached", 1, GRAPH_H, GRAPH_H, GRAPH_S, GRAPH_S,
     GRAPH_S, GRAPH_E // GRAPH_H, 0, "f32", "f32", 0.0, True),
    # path m1 (D 32): the training forward, a perplexity window's prefill
    ("chain_train_d32", "cached", 240, 6, 6, 128, 128, 128, 32, 0, "f32",
     "f32", 0.0, True),
    ("chain_ppl_prefill_d32", "cached", 1, 6, 6, 127, 127, 127, 32, 0, "f32",
     "f32", 0.0, True),
]
# kernel 3 beyond the serving and path e shapes: (label, B, Hq, Hkv, T, D,
# cache), npast = T - 1
ATTN_DECODE_TIMING = [
    ("b8_T64", SLOTS, 32, 32, 64, 128, "int8"),
    ("b8_T256", SLOTS, 32, 32, 256, 128, "int8"),
    ("b8_T2048", SLOTS, 32, 32, 2048, 128, "int8"),
    ("b1_T64", 1, 32, 32, 64, 128, "int8"),
    ("b1_T2048", 1, 32, 32, 2048, 128, "int8"),
    ("gqa8_int8_T2048", SLOTS, 32, 8, 2048, 128, "int8"),
    ("gqa4_bf16_d64_T300", 4, 8, 2, 300, 64, "bf16"),
    # path m2's step (D 32, E_kv 192, 96 slots)
    ("m2_int8_d32_T128", KVQ_CHUNKS, 6, 6, 128, 32, "int8"),
    ("m2_bf16_d32_T128", KVQ_CHUNKS, 6, 6, 128, 32, "bf16"),
]


def time_flash_shape(dev, gen, entry, B, Hq, Hkv, S, T, Ta, D, npast, qd,
                     kvd, cap, cold):
    """One kernel-2 call: kernel, plain version and SDPA (no softcap: none),
    CUDA-graph replay; SDPA takes q's dtype (its K/V copies are made before
    timing). The uncached entry takes lead dims (B, Hq) and Hkv = Hq."""
    import torch

    from ggmlsharp_tpu_torch.kernels.flash import (
        _cached_ref, _uncached_ref, flash_attention, flash_attention_cached)

    qt, kt = getattr(torch, _KV_DT[qd]), getattr(torch, _KV_DT[kvd])
    per = (B * Hq * S * D * qt.itemsize + 2 * B * Hkv * Ta * D * kt.itemsize)
    copies = max(2, -(-4 * L2_BYTES // per)) if cold else 1
    xs = []
    for _ in range(copies):
        q = torch.randn((B, Hq, S, D), generator=gen, device=dev).to(qt)
        k, v = (torch.randn((B, Hkv, Ta, D), generator=gen, device=dev)
                .to(kt)[:, :, :T] for _ in range(2))
        xs.append((q, k, v, k.to(qt), v.to(qt)))
    np_t = torch.full((B,), npast, dtype=torch.int32, device=dev)
    sc = D ** -0.5
    if entry == "cached":
        kern = lambda i: flash_attention_cached(*xs[i % copies][:3], np_t,
                                                softcap=cap)
        plain = lambda i: _cached_ref(*xs[i % copies][:3], np_t, sc, cap)
    else:
        kern = lambda i: flash_attention(*xs[i % copies][:3], causal=True,
                                         n_past=npast, softcap=cap)
        plain = lambda i: _uncached_ref(*xs[i % copies][:3], True, npast, sc,
                                        cap).to(qt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = torch.arange(T, device=dev)[None, :] <= \
        torch.arange(S, device=dev)[:, None] + npast  # [S, T], True = keep
    causal = npast == 0 and S == T
    lib = (lambda i: sdpa(xs[i % copies][0], *xs[i % copies][3:],
                          is_causal=True)) if causal else \
        (lambda i: sdpa(xs[i % copies][0], *xs[i % copies][3:],
                        attn_mask=mask))
    reps = max(100, copies)
    with torch.no_grad():
        ms = time_ms(kern, reps)
        res = {"ms": ms, "plain_ms": time_ms(plain, max(20, copies)),
               "library_ms": None if cap else time_ms(lib, reps)}
    out_bytes = 4 if entry == "cached" else qt.itemsize
    res["bound_ms"], res["bound_by"] = flash2_bound_ms(
        B, Hq, Hkv, S, T, D, qt.itemsize, out_bytes, npast,
        kv_bytes=kt.itemsize)
    res.update(roofline_share=res["bound_ms"] / ms, cold_copies=copies)
    del xs
    torch.cuda.empty_cache()
    return res


def time_attention(dev, gen):
    """Kernels 2 and 3 at every shape a path runs them (FLASH_TIMING,
    ATTN_DECODE_TIMING): each time beside its bound, plain and SDPA time."""
    flash = {}
    for label, *args in FLASH_TIMING:
        flash[label] = time_flash_shape(dev, gen, *args)
    decode = {}
    for label, B, Hq, Hkv, T, D, kind in ATTN_DECODE_TIMING:
        decode[label] = time_decode_shape(dev, gen, B, Hq, Hkv, T, D, kind)
    res = {"flash_attn": flash, "attn_decode": decode}
    emit({"attention_timing": res})
    return res


# --- the tuning slice: the TPU probes' counterparts (sites 12-17, the last
# pallas_call sites of the repo, in scripts/), the launch geometry of the
# three dequant-matmul sources and the tune table that dispatch reads, and
# path i (LLAMA_13B Q4_0 decode through the tuned dispatch) ------------------
I_NEW = 8  # path i: greedy tokens after the 16-token prompt
I_LAYERS = 20  # path i's depth (of 40): cut for the script's time limit
GEOM_SHAPES = [("7b_wo", 4096, 4096), ("ragged", 4099, 11008)]
GEOM_B = (1, 5)


def check_geometries(dev, gen):
    """Every launch geometry compiled into the three dequant-matmul sources
    (tune.GEOMETRIES_OF: the b = 1 streaming instance also at 16 warps)
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
        kern = {"Q4_0": "matmul_q4_0", "Q8_0": "matmul_q8_0"}.get(fmt,
                                                                "matmul_q")
        for label, n, k in GEOM_SHAPES:
            w = random_weight(fmt, n, k, gen, dev)
            for b in GEOM_B:
                x = torch.randn((b, k), generator=gen, device=dev)
                ref = fn(x, w, tune.DEFAULT)
                same = {f"{g[0]}x{g[1]}": bool(torch.equal(fn(x, w, g), ref))
                        for g in tune.GEOMETRIES_OF[kern]}
                rows.append({"format": fmt, "shape": label, "n": n, "k": k,
                             "b": b, "bit_equal_default": same,
                             "finite": bool(torch.isfinite(ref).all())})
                if not (all(same.values()) and rows[-1]["finite"]):
                    emit({"geometry_check": rows})
                    raise SystemExit(f"a launch geometry changes the bits: "
                                     f"{rows[-1]}")
    emit({"geometry_check": {"cases": len(rows), "geometries": {
        kern: [list(g) for g in gs] for kern, gs in tune.GEOMETRIES_OF.items()},
        "all_bit_equal": True}})
    return len(rows)


def run_probe_path(dev):
    """The TPU probes' counterparts through their entry points' run(): the
    three Q4_UNPACK builds (i2f bit-equal to prmt, half2 within its bar),
    the copy ceiling at 8 MB and 1 GiB, the byte map, the K-major matvec
    (checked and timed), the f16 decode, the block maps and the bad-entry
    map; and kernel 4's two builds for Q8_0 activations (probes/q8_acts.py:
    both checked and timed); counters reset just before, read just
    after."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.probes import (dq_variants, q8_acts,
                                            scale_decode, swar)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = {"dq": dq_variants.run(dev), "swar": swar.run(dev),
           "scale": scale_decode.run(dev), "q8_acts": q8_acts.run(dev)}
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    ran = ("matmul_q4_0", "matmul_q4_0_i2f", "matmul_q4_0_half2",
           "probe_copy", "probe_byte_order", "matmul_q4_0_kmajor",
           "probe_f16_decode", "probe_block_map", "matmul_q8_0_mma")
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
    default geometry at its shape, cold L2, three rounds in turns, at
    b = 1, the only instance that reads a geometry (more rows take Q8_0's
    RB = 8 instance at the default, the other formats' multi-row instance
    at none). Then the host time of one dispatch lookup
    (matmul_q.geometry)."""
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
        kern, g = kinds.get(key, (None, None))
        geom = tune.legal(ent, kern)
        if geom is None or key not in kinds:
            raise SystemExit(f"tune table entry {key}: {ent} is not legal")
        n, k = (int(v) for v in key.split(":")[1].split("x"))
        ws = autotune.random_copies(g, n, k, gen, dev)
        fn = autotune.launcher(kern)
        reps = int(min(200, max(20, 1e-3 * 2.5e12 / ws[0].nbytes())))
        row = {"key": key, "geometry": list(geom)}
        for b in (1,):
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
    gains = [r["b1"]["gain"] for r in rows] or [1.0]
    out = {"card": tcard, "entries": len(rows), "rows": rows,
           "gain_b1_median": statistics.median(gains),
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
    """Path i: LLAMA_13B (full width, depth cut to I_LAYERS of its 40
    layers) Q4_0 at b = 1, random N(0, 1/k) weights quantized on the card
    one tensor at a time, a bf16 head-major cache of n_ctx rows: a 16-token
    prompt and I_NEW greedy tokens, counters reset just before; every
    matmul through matmul_q4_0 at the tune table's geometry for its shape
    (else the default), flash for the prompt; held against the plain
    route; then tok/s and the share of the HBM roofline."""
    import dataclasses

    import torch

    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.kernels import _build, tune
    from ggmlsharp_tpu_torch.kernels.matmul_q import geometry
    from ggmlsharp_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LLAMA_13B, n_layer=I_LAYERS)
    t0 = time.perf_counter()
    params = llama.synthetic_params(cfg, GType.Q4_0, seed=SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.n_vocab, (1, PROMPT_LEN), generator=gen,
                           device=dev, dtype=torch.int32)
    L = cfg.n_layer
    toks, counts = run_fused_path(
        cfg, params, prompt, "i LLAMA_13B Q4_0, head-major bf16 cache",
        I_NEW, {**dq_launches("matmul_q4_0", 4 * L + 1, (4 * L + 1) * I_NEW),
                "flash_attn": L}, tag="llama_13b_path")
    geo = {k: v for k, v in _build.GEOMETRY_LAUNCHES.items()}
    shapes = {}
    for (kern, n, k, w, r, b), c in geo.items():
        want = geometry(kern, n, k, GType.Q4_0) if b == 1 else (None, None)
        shapes[f"{n}x{k} b{b}"] = {
            "geometry": [w, r], "launches": c,
            "from_table": b == 1
            and tune.lookup(kern, n, k, GType.Q4_0) is not None}
        if kern != ("matmul_q4_0" if b == 1 else "matmul_q4_0_mma") \
                or (w, r) != want:
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
    dec.update(config=f"LLAMA_13B Q4_0, {I_LAYERS} layers", card=smi,
               load_s=load_s,
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
    return profile_summary(prof, wall, n_steps)


def profile_adam_window(loss, x0, first, n_steps, eager):
    """torch.profiler over Adam iterations first .. first + n_steps - 1 of
    one opt_fn call from x0 (stopping rules off), started and stopped from
    its callback, each iteration's host read included: in the captured
    form (first >= 3) graph replays, iteration 1 being the eager warm-up
    and 2 the capture; with ``eager`` the eager form's iterations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.optim import opt_fn

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t = {}

    def on_step(it, f):
        if it == first - 1:
            torch.cuda.synchronize()
            prof.start()
            t["start"] = time.perf_counter()
        elif it == first + n_steps - 1:
            torch.cuda.synchronize()
            t["wall"] = time.perf_counter() - t["start"]
            prof.stop()

    with captured.disabled() if eager else contextlib.nullcontext():
        opt_fn(loss, x0, adam_params(first + n_steps - 1), on_step)
    return profile_summary(prof, t["wall"], n_steps)


def adam_params(n_iter):
    """Adam for n_iter iterations, AdamParams' alpha, no stopping rule."""
    from ggmlsharp_tpu_torch.optim import OptParams, OptType

    prm = OptParams(type=OptType.ADAM)
    prm.adam.n_iter = n_iter
    prm.adam.eps_f = 0.0
    prm.past = prm.max_no_improvement = 0
    return prm


def profile_summary(prof, wall, n_steps):
    """A profiler window's device kernel time, kernel launches and aten
    calls a step, and the kernels that take the most device time."""
    import torch

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
                   eager=False, eager_ref=None, **cache_kw):
    """Prefill time, then per-token decode latency at b = 1 (host clock,
    synchronised each step; n_lat steps after n_warm), an n_win-token
    window without per-step sync (and its launches a step), and a traced
    n_prof-step window (profile_steps). The step is make_decode_fns' step:
    captured (one graph a length bucket; captured during the warm-up
    steps), or with ``eager`` its eager form (captured.disabled()); the
    captures, replays and capture seconds are counted; the captured
    form's trace is checked against ``eager_ref`` (an eager profile_steps
    of this step), else against 2 eager steps traced here. ``model``:
    models.llama or models.gpt2; weight_bytes: the matmul weights a token
    reads once; kv_width: elements of one cached K (or V) row;
    kv_row_bytes: its bytes (default bf16: 2 * kv_width); cache_kw goes to
    new_cache."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured, sampling

    prefill, step = sampling.make_decode_fns(model.forward, cfg)
    T = cfg.n_ctx
    res = {"form": "eager" if eager else "captured"}
    captured.reset_counts()
    with torch.inference_mode(), \
            captured.disabled() if eager else contextlib.nullcontext():
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
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(n_win):
            one_step()
        torch.cuda.synchronize()
        win = time.perf_counter() - t0
        res["launches_per_step"] = sum(kernels.LAUNCHES.values()) / n_win
        cur = state["cur"]
        res["profile"] = profile_steps(one_step, n_prof)
        if not eager and eager_ref is None:  # to check this trace by
            with captured.disabled():
                eager_ref = profile_steps(one_step, 2)
    if not eager:
        check_trace(res["profile"], eager_ref)
    res.update(captured.COUNTS)
    lat_ms = sorted(x * 1e3 for x in lat)
    res["step_ms_median"] = statistics.median(lat_ms)
    res["step_ms_p84"] = lat_ms[int(0.84 * len(lat_ms))]
    res["step_samples"] = len(lat_ms)
    res["window_tok_s"] = n_win / win
    set_idle_share(res)
    # bytes a token must move: every matmul weight once plus the live K/V
    live = cur - n_win // 2
    kv_bytes = 2 * cfg.n_layer * live * (kv_row_bytes or 2 * kv_width)
    res["weight_bytes"] = weight_bytes
    res["bytes_per_token"] = weight_bytes + kv_bytes
    res["roofline_tok_s"] = HBM_BYTES_S / (weight_bytes + kv_bytes)
    res["roofline_share"] = res["window_tok_s"] / res["roofline_tok_s"]
    return res


def set_idle_share(res):
    """The idle share of an untraced step: the trace's device time a step
    over the untraced median step (tracing slows the host, not the
    kernels)."""
    prof = res["profile"]
    dev_ms = prof["device_ms_per_step"]
    res["device_idle_share"] = (1.0 - dev_ms / res["step_ms_median"]
                                if isinstance(dev_ms, float)
                                else "not measured")
    ref = prof.get("eager_trace_device_ms_per_step")
    if isinstance(ref, float):  # the same kernels, traced in the eager form
        res["idle_share_by_eager_trace"] = 1.0 - ref / res["step_ms_median"]


def decode_forms(*args, **kw):
    """measure_decode in the eager form (32 + 32 steps and 4 traced: its
    steps take ~10x the captured ones'), then the captured one (the
    default), on one card in one call: the captured record, the eager one
    under "eager", and the step ms and tok/s ratios. The launches a step
    must be equal."""
    eager = measure_decode(*args, eager=True, **{
        **kw, "n_lat": 32, "n_win": 32, "n_prof": 4})
    dec = measure_decode(*args, eager_ref=eager["profile"], **kw)
    if dec["launches_per_step"] != eager["launches_per_step"]:
        raise SystemExit(f"decode launches a step: captured "
                         f"{dec['launches_per_step']}, eager "
                         f"{eager['launches_per_step']}")
    dec["eager"] = {k: v for k, v in eager.items()
                    if k not in ("weight_bytes", "bytes_per_token",
                                 "roofline_tok_s")}
    dec["speedup_window_tok_s"] = dec["window_tok_s"] / eager["window_tok_s"]
    dec["speedup_step_ms_median"] = (eager["step_ms_median"]
                                     / dec["step_ms_median"])
    return dec


def gpt2_weight_bytes(params):
    """Q8_0 bytes a GPT-2 decode token reads once: four weights a block and
    wte (the LM head)."""
    return params["wte"].nbytes() + sum(
        blk[grp][key].nbytes() for blk in params["blocks"]
        for grp, key in (("attn", "c_attn_w"), ("attn", "c_proj_w"),
                         ("mlp", "c_fc_w"), ("mlp", "c_proj_w")))


def attention_timing(dev):
    """--attention-timing [ROOT], a development mode (no compatibility
    promise): kernels 2 and 3 of the package under ROOT (default: this
    checkout) built and timed at every shape a path runs them, nothing
    else; so two checkouts' kernels can be timed by one script, in one
    call, on one card."""
    import torch

    from ggmlsharp_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(["flash_attn", "attn_decode"])
    log(f"built kernels 2 and 3 in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(dev).manual_seed(SEED)
    time_attention(dev, gen)


MATMUL_TIMING_Q8_B = (1, 2, 3, 4, 16, 128)  # kernel 4: the crossover, paths


def bits_digests(dev):
    """A digest (sha256, 16 hex digits) of the output of the b = 1 Q4_0
    matvec at every 7B shape (f32 x in both mm_dot modes), of kernel 10
    (Llama-7B block, T 256, npast 32) and of kernel 11 (GPT-2 124M and 774M
    blocks, T 256, npast 32), each on inputs made from a fixed seed: two
    trees whose digests agree give those kernels the same bits."""
    import hashlib

    import torch

    from ggmlsharp_tpu_torch.kernels.gpt2_layer import gpt2_layer_step
    from ggmlsharp_tpu_torch.kernels.llama_layer import (llama_layer_step,
                                                         rope_vectors)
    from ggmlsharp_tpu_torch.kernels.matmul_q import q4_0_matmul
    from ggmlsharp_tpu_torch.models import llama

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()) \
            .hexdigest()[:16]

    gen = torch.Generator(dev).manual_seed(SEED + 14)
    out = {}
    for name, n, k, _ in Q4_SHAPES:
        w = llama.random_q4_0(n, k, gen, dev)
        x = torch.randn((1, k), generator=gen, device=dev)
        for mode in ("f32", "bf16"):
            out[f"matmul_q4_0 {name} {mode}"] = digest(
                q4_0_matmul(x, w["qs"], w["d"], mode=mode))
    cfg, blocks = llama_blocks(llama.LLAMA_7B, 1, SEED + 14, gen, dev)
    Ekv = cfg.n_head_kv * cfg.head_dim
    kc = torch.randn((256, Ekv), generator=gen, device=dev).bfloat16()
    np_t = torch.tensor([32], dtype=torch.int32, device=dev)
    x = torch.randn((1, cfg.n_embd), generator=gen, device=dev)
    out["llama_layer 7B"] = digest(llama_layer_step(
        blocks[0], x, kc, kc, np_t, cfg, rope_vectors(np_t, cfg))[0])
    del blocks
    for tag, gcfg in gpt2_configs():
        blk = gpt2_blocks(gcfg, 1, SEED + 14)[0]
        E = gcfg.n_embd
        kc = torch.randn((256, E), generator=gen, device=dev).bfloat16()
        x = torch.randn((1, E), generator=gen, device=dev)
        np1 = torch.tensor(32, dtype=torch.int32, device=dev)
        out[f"gpt2_layer {tag}"] = digest(gpt2_layer_step(
            blk, x, kc, kc, np1, gcfg.n_head, gcfg.ln_eps)[0])
    torch.cuda.empty_cache()
    emit({"bits": out})
    return out


def matmul_timing(dev):
    """--matmul-timing [ROOT], a development mode (no compatibility
    promise): the dequant-matmuls and kernel 9 of the package under ROOT
    built and timed, nothing else (the plain version at b = 1 only): Q4_0,
    Q4_K, Q6_K at every 7B shape and the legacy formats at w_gate_up
    (time_weight_rows);
    Q8_0 at the GPT-2 shapes of time_q8_0, b in MATMUL_TIMING_Q8_B, and at
    every 7B shape, b 16 (path f's Q8_0 prompt: Q8_0 and f32 x, the LM head
    f32); f32 x also in mm_dot "bf16" where the package reads the mode;
    kernel 9 at SILU_TIMING_ROWS (time_mlp_fused_silu); kernel 8 at
    MLP_TIMING_ROWS at both GPT-2 widths, Q8_0 and f32 x
    (time_mlp_fused); kernel 10 at npast 32 and 2047, and without its
    products (time_llama_layer); kernel 11 at both widths and every
    GPT2_LAYER_TIMING case, and without its products (time_gpt2_layer);
    kernel 7 in its five formats at the four 7B decode shapes
    (time_int_dot)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.kernels import _build

    names = [n for n in ("matmul_q4_0", "matmul_q", "matmul_q8_0",
                         "mlp_fused_silu_q4", "matmul_q4_0_mma",
                         "matmul_q_mma", "matmul_q8_0_mma",
                         "mlp_fused_silu_q4_mma", "mlp_fused_q8",
                         "mlp_fused_q8_mma", "llama_layer", "gpt2_layer",
                         "matmul_int_dot")
             if n in _build.KERNELS]
    t0 = time.perf_counter()
    kernels.build(names)
    log(f"built {names} in {time.perf_counter() - t0:.1f} s")
    bits_digests(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for fmt in ("Q4_0", *E_FORMATS):
        rows += time_weight_rows(dev, gen, fmt, Q4_SHAPES, TIMING_B,
                                 plain=(1,))
    for fmt in A_FORMATS[:5]:
        rows += time_weight_rows(dev, gen, fmt, Q4_SHAPES[2:3], (1, 16),
                                 plain=(1,))
    emit({"matmul_timing": rows})
    for fmt in ("Q4_0", *E_FORMATS):
        log(f"{fmt} prompt forward (129 launches, b 16): "
            f"{forward_sum(rows, fmt, 16)['ms']:.3f} ms; decode token: "
            f"{forward_sum(rows, fmt, 1)['ms']:.3f} ms")
    q8, _, _ = time_q8_0(dev, gen, None, MATMUL_TIMING_Q8_B, plain=False)
    for tag, _ in gpt2_configs():
        sel = [r for r in q8 if r["config"] == tag]
        log(f"GPT-2 {tag} prompt forward's kernel-4 launches (b 16): "
            f"{forward_sum(sel, 'Q8_0', 16)['ms']:.4f} ms; serving decode "
            f"step's (b 2, f32): {forward_sum(sel, 'Q8_0', 2, 'f32')['ms']:.4f}"
            f" ms")
    f_shapes = [(name, n, k, 1 if name == "output" else F_LAYERS)
                for name, n, k, _ in Q4_SHAPES]
    q8_7b = time_weight_rows(dev, gen, "Q8_0", f_shapes, (16,), plain=False)
    emit({"matmul_timing_q8_0_7b": q8_7b})
    log(f"path f2's Q8_0 prompt forward ({F_LAYERS} layers, b 16): "
        f"{forward_sum(q8_7b, 'Q8_0', 16)['ms']:.4f} ms")
    silu = time_mlp_fused_silu(dev, gen, plain=False)
    log("kernel 9 ms: " + ", ".join(
        f"{r['config']} {r['rows']} {r['acts']} {r['ms']:.4f}" for r in silu))
    log("kernel 9 one row, routes with the Q8_0 round trip (ms): " + ", ".join(
        f"{r['config']} fused {r['fused_route_ms']:.4f} unfused "
        f"{r['unfused_ms']:.4f} library {r['library_ms']:.4f}"
        for r in silu if "unfused_ms" in r))
    gelu = time_mlp_fused(dev, gen, plain=False)
    log("kernel 8 ms: " + ", ".join(
        f"{r['config']} {r['rows']} {r['acts']} {r['ms']:.4f}" for r in gelu))
    log("kernel 8 one row, routes (ms): " + ", ".join(
        f"{r['config']} {r['acts']} fused {r['fused_route_ms']:.4f} unfused "
        f"{r['unfused_ms']:.4f} library {r['library_ms']:.4f}"
        for r in gelu if "unfused_ms" in r))
    lay = time_llama_layer(dev, gen, plain=False)
    log(f"kernel 10 ms: npast 32 {lay['ms']:.4f}, npast 2047 "
        f"{lay['npast_2047']['ms']:.4f}, no products "
        f"{lay['no_matvec_ms']}")
    blk = time_gpt2_layer(dev, gen, plain=False)
    log("kernel 11 ms: " + ", ".join(
        f"{r['config']} T {r['T']} npast {r['npast']} {r['cache']} "
        f"{r['ms']:.4f}" for r in blk["shapes"])
        + f"; no products 124M {blk['no_matvec_ms']:.4f}, 774M "
        f"{blk['gpt2_774m']['no_matvec_ms']:.4f}")
    ib = time_int_dot(dev, gen, None, plain=False)
    log("kernel 7 ms: " + ", ".join(f"{r['format']} {r['shape']} "
                                    f"{r['ms']:.4f}" for r in ib))


# path j (a model from files: GGUF, safetensors, a checkpoint) ---------------
J_CHUNK, J_CHUNKS = 256, 2  # j1's perplexity: two windows of 256 tokens
J_TRAINED = 512             # pieces train_spm_vocab learns before the filler
J_NEW_HTTP = 8              # new tokens of j1's HTTP requests


def corpus_text(repo):
    with open(os.path.join(repo, "tests", "data", "tiny_corpus.txt"),
              encoding="utf-8") as f:
        return f.read()


def scratch_dir(need_bytes):
    """A fresh directory for a path's files (j, l) where need_bytes and 1
    GiB more are free: the temporary directory, else the package's
    gitignored _build/. Raises if neither has the room."""
    import shutil
    import tempfile

    from ggmlsharp_tpu_torch.kernels._build import BUILD_DIR

    tried = []
    for base in (tempfile.gettempdir(), BUILD_DIR):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        tried.append((base, free))
        if free >= need_bytes + 2**30:
            return tempfile.mkdtemp(prefix="chip_smoke_j_", dir=base)
    raise SystemExit(f"no room for {need_bytes / 1e9:.2f} GB of a path's "
                     f"files (free bytes: {tried})")


def expect_launches(part, counts, want):
    if counts != want:
        raise SystemExit(f"path {part}: launch counts {counts} != {want}")


def require_launches(part, counts, names):
    """Each kernel of ``names`` launched at least once (a part whose counts
    depend on the engine's scheduling)."""
    if not all(counts[n] for n in names):
        raise SystemExit(f"path {part}: launches {counts} miss one of "
                         f"{names}")


def bit_diffs(a, b, path=""):
    """Paths at which two trees (dicts, lists, tensors, QTensors, None)
    differ in structure, dtype or bits."""
    import torch

    from ggmlsharp_tpu_torch.quant.formats import QTensor

    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) \
                or set(a) != set(b):
            return [path]
        return [d for k in a for d in bit_diffs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if not isinstance(b, type(a)) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in bit_diffs(x, y, f"{path}/{i}")]
    if a is None or b is None:
        return [] if a is b else [path]
    if isinstance(a, QTensor) or isinstance(b, QTensor):
        if not (isinstance(a, QTensor) and isinstance(b, QTensor)) \
                or (a.gtype, a.shape) != (b.gtype, b.shape):
            return [path]
        return [d for k in a.planes
                for d in bit_diffs(a[k], b.planes.get(k), f"{path}/{k}")]
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        return [] if a == b else [path]
    same = a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(a.detach(), b.detach())
    return [] if same else [path]


def prompt_logits(model, cfg, params, prompt, **cache_kw):
    """The prefill's logits of ``prompt`` (generate's first forward)."""
    import torch

    from ggmlsharp_tpu_torch.models import sampling

    S = prompt.shape[1]
    with torch.inference_mode():
        lg, _ = model.forward(
            params, cfg, prompt, model.new_cache(cfg, 1, **cache_kw),
            torch.arange(S, dtype=torch.int32, device=prompt.device)[None],
            prefix_bound=sampling.length_bucket(S, cfg.n_ctx))
    return lg


def first_differing_launch(model, cfg, a, b, prompt):
    """The first matmul of the prefill whose output differs between trees
    a and b: its index in launch order, the weight's shape and the largest
    difference. None if every matmul output is equal."""
    import torch

    from ggmlsharp_tpu_torch.models import captured

    rec, orig = [], model.linear

    def spy(w, x, *args, **kw):
        y = orig(w, x, *args, **kw)
        rec[-1].append((tuple(w.shape), y.detach().clone()))
        return y

    model.linear = spy
    try:
        with captured.disabled():  # a replay would not call the spy
            for tree in (a, b):
                rec.append([])
                prompt_logits(model, cfg, tree, prompt)
    finally:
        model.linear = orig
    for i, ((sa, ya), (_, yb)) in enumerate(zip(*rec)):
        if not torch.equal(ya, yb):
            return {"launch": i, "weight_shape": sa,
                    "max_abs_diff": float((ya - yb).abs().max())}
    return None


def padded_vocab(text, n_vocab):
    """train_spm_vocab over the corpus (J_TRAINED pieces), then unique
    filler pieces up to n_vocab. No merge can form a filler: neither half
    of one is a piece."""
    from ggmlsharp_tpu_torch.io import train_spm_vocab

    toks, scores = train_spm_vocab(text, size=J_TRAINED)
    n = len(toks)
    return (toks + [f"<fill{i:05d}>" for i in range(n_vocab - n)],
            scores + [-1e9] * (n_vocab - n), n)


def with_norms(params, dtype):
    """The tree with its norm gains cast to ``dtype`` (a GGUF stores them as
    F32, as llama.cpp writes them; path a's tree holds them in bf16, so the
    cast of ones is exact)."""
    out = {**params, "norm": params["norm"].to(dtype)}
    out["blocks"] = [{**b, "attn_norm": b["attn_norm"].to(dtype),
                      "ffn_norm": b["ffn_norm"].to(dtype)}
                     for b in params["blocks"]]
    return out


def post_json(port, body, timeout=300):
    import urllib.request

    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps(body).encode()), timeout=timeout) as r:
        return json.loads(r.read())


def run_gguf_path(smi, repo, cfg, params, prompt, toks_a):
    """Path j1: path a's Llama-7B Q4_0 tree (unfused, unpadded) and a
    vocabulary trained on the corpus, padded to n_vocab, written with
    save_gguf_llama; loaded back onto the card with load_gguf_llama and
    tokenizer_from_gguf. Each tensor's wire bytes against the writer's
    digests; both encoders on a corpus sentence; a 16-token prompt and N_NEW
    greedy tokens through sampling.generate on the fused loaded tree (path
    a's tokens, prompt logits bit for bit); the tokens decoded; perplexity
    over J_CHUNKS windows of J_CHUNK tokens of the corpus (weight-only and
    mm_dot "f32": kernels against the plain route, per-token NLL within
    2e-3, twice path a's weight-only 1e-3 on logits, as a log-softmax moves
    by at most twice its logits' largest difference; then timed in the
    default settings, captured (one graph a call) and then eager, the same
    perplexity in both); a "text" request through EngineServer with the
    file's tokenizer. Counters reset before each part and read after."""
    import functools
    import hashlib
    import shutil

    import numpy as np
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.eval import nll_chunk, perplexity
    from ggmlsharp_tpu_torch.io import (GGUFReader, SPMTokenizer,
                                        load_gguf_llama, save_gguf_llama,
                                        tokenizer_from_gguf)
    from ggmlsharp_tpu_torch.io.gguf import (llama_tensor_names,
                                             qtensor_to_wire, wire_nbytes)
    from ggmlsharp_tpu_torch.models import captured, llama, sampling
    from ggmlsharp_tpu_torch.quant.formats import QTensor
    from ggmlsharp_tpu_torch.serving import EngineServer

    text = corpus_text(repo)
    t0 = time.perf_counter()
    vocab, scores, n_trained = padded_vocab(text, cfg.n_vocab)
    res = {"card": smi, "vocab_trained": n_trained, "n_vocab": len(vocab),
           "vocab_s": time.perf_counter() - t0}
    parts = {}
    unf = llama.unfuse_params(params, cfg)
    need = sum(wire_nbytes(t.gtype, t.shape) if isinstance(t, QTensor)
               else 4 * t.numel() for _, t in llama_tensor_names(unf))
    d = scratch_dir(need)
    path = os.path.join(d, "llama-7b-q4_0.gguf")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        digests = save_gguf_llama(path, cfg, unf,
                                  tokenizer=SPMTokenizer(vocab, scores))
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        cfg2, loaded = load_gguf_llama(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        reader = GGUFReader(path)
        tk, tk_nat = tokenizer_from_gguf(reader), \
            tokenizer_from_gguf(reader, native=True)
        t0 = time.perf_counter()
        bad = [n for n, t in llama_tensor_names(loaded)
               if hashlib.sha256(qtensor_to_wire(t)[1]).hexdigest()
               != digests.pop(n)]
        digest_s = time.perf_counter() - t0
        if bad or digests or set(reader.tensors) != {
                n for n, _ in llama_tensor_names(loaded)}:
            raise SystemExit(f"path j1: wire digests differ for {bad}, "
                             f"unread {sorted(digests)}")
        del reader
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if cfg2 != cfg:
        raise SystemExit(f"path j1: loaded config {cfg2} != {cfg}")
    res.update(file_bytes=size, dir=os.path.dirname(d), write_s=write_s,
               write_gb_s=size / write_s / 1e9, load_s=load_s,
               load_gb_s=size / load_s / 1e9, digest_s=digest_s,
               tensors=len(llama_tensor_names(loaded)),
               page_cache="warm: the load reads the file just written")

    sentence = text.split(".")[0].strip() + "."
    ids = tk.encode(sentence)
    if tk_nat.encode(sentence) != ids or tk.decode(ids) != sentence:
        raise SystemExit(f"path j1: the encoders differ on {sentence!r}")
    res["sentence_tokens"] = len(ids)

    fused = with_norms(llama.fuse_params(loaded), params["norm"].dtype)
    del loaded
    diffs = bit_diffs(fused, params)
    if diffs:
        raise SystemExit(f"path j1: the loaded tree differs from path a's at "
                         f"{diffs[:8]}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks, cache = sampling.generate(llama.forward, cfg, fused, prompt,
                                    llama.new_cache(cfg, 1), N_NEW)
    torch.cuda.synchronize()
    res["generate_s"] = time.perf_counter() - t0
    parts["generate"] = dict(kernels.LAUNCHES)
    expect_launches("j1 generate", parts["generate"], llama_b1_launches(cfg))
    la = prompt_logits(llama, cfg, params, prompt)
    lb = prompt_logits(llama, cfg, fused, prompt)
    res["prompt_logits_bit_equal"] = bool(torch.equal(la, lb))
    if not res["prompt_logits_bit_equal"]:
        res["first_differing_launch"] = first_differing_launch(
            llama, cfg, params, fused, prompt)
        raise SystemExit(f"path j1: prompt logits differ from path a's: "
                         f"{res['first_differing_launch']}")
    if not torch.equal(toks, toks_a):
        raise SystemExit(f"path j1: tokens {toks.tolist()} != path a's "
                         f"{toks_a.tolist()}")
    res["tokens"] = toks[0].tolist()
    res["text"] = tk.decode(res["tokens"])

    stream = np.asarray(tk_nat.encode(text[:8000]), np.int32)
    n = J_CHUNK * J_CHUNKS + 1
    if len(stream) < n:
        raise SystemExit(f"path j1: the corpus gave {len(stream)} tokens")
    stream = stream[:n]
    os.environ["GGML_TPU_QUANT_ACTS"] = "0"
    t0 = time.perf_counter()
    try:
        with mm_dot("f32"):
            torch.cuda.synchronize()
            kernels.reset_launches()
            ppl_k = perplexity(llama.forward, cfg, fused, stream, J_CHUNK)
            torch.cuda.synchronize()
            parts["perplexity"] = dict(kernels.LAUNCHES)
            plain = functools.partial(llama.forward, plain=True)
            ppl_p = perplexity(plain, cfg, fused, stream, J_CHUNK)
            err = 0.0
            for i in range(J_CHUNKS):
                c = torch.from_numpy(stream[i * J_CHUNK:(i + 1) * J_CHUNK][
                    None]).to(prompt.device)
                err = max(err, float((nll_chunk(llama.forward, cfg, fused, c)
                                      - nll_chunk(plain, cfg, fused, c))
                                     .abs().max()))
    finally:
        os.environ.pop("GGML_TPU_QUANT_ACTS")
    want = dict.fromkeys(kernels.LAUNCHES, 0) | {
        **dq_launches("matmul_q4_0", (4 * cfg.n_layer + 1) * J_CHUNKS, 0),
        "flash_attn": cfg.n_layer * J_CHUNKS}
    expect_launches("j1 perplexity", parts["perplexity"], want)
    res["perplexity_weight_only"] = {
        "ppl": ppl_k[0], "mean_nll": ppl_k[1], "scored": ppl_k[2],
        "plain_ppl": ppl_p[0], "plain_mean_nll": ppl_p[1],
        "max_abs_nll_err": err, "tol": 2e-3,
        "seconds": time.perf_counter() - t0}
    if not (err <= 2e-3 and abs(ppl_k[1] - ppl_p[1]) <= 2e-3
            and ppl_k[2] == ppl_p[2] == J_CHUNKS * (J_CHUNK - 1 - J_CHUNK // 2)
            and np.isfinite(ppl_k[0])):
        raise SystemExit(f"path j1: perplexity kernels vs plain: "
                         f"{res['perplexity_weight_only']}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    captured.reset_counts()
    t0 = time.perf_counter()
    ppl_d = perplexity(llama.forward, cfg, fused, stream, J_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cap = dict(captured.COUNTS)
    parts["perplexity_default"] = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    with captured.disabled():
        ppl_e = perplexity(llama.forward, cfg, fused, stream, J_CHUNK)
    torch.cuda.synchronize()
    secs_e = time.perf_counter() - t0
    res["perplexity_default"] = {
        "ppl": ppl_d[0], "mean_nll": ppl_d[1],
        "chunk_ms": secs * 1e3 / J_CHUNKS,
        "window_ms_replayed": (secs - cap["capture_s"]) * 1e3 / J_CHUNKS,
        "captures": cap["captures"], "replays": cap["replays"],
        "capture_s": cap["capture_s"], "eager_chunk_ms": secs_e * 1e3
        / J_CHUNKS, "eager_mean_nll": ppl_e[1],
        "rows_a_chunk": J_CHUNK - 1, "clock": "host, after a sync"}
    expect_launches("j1 perplexity (default settings)",
                    parts["perplexity_default"], want)
    if (cap["captures"], cap["replays"]) != (1, J_CHUNKS) \
            or abs(ppl_e[1] - ppl_d[1]) > 2e-3:
        raise SystemExit(f"path j1: captured perplexity vs its eager form: "
                         f"{res['perplexity_default']}")

    t0 = time.perf_counter()
    eng = new_engine(cfg, fused)
    srv = EngineServer(eng, port=0, tokenizer=tk).start()
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        by_text = post_json(srv.port, {"text": sentence,
                                       "max_new_tokens": J_NEW_HTTP})
        by_ids = post_json(srv.port, {"prompt": ids, "eos_id": tk.eos_id,
                                      "max_new_tokens": J_NEW_HTTP})
        torch.cuda.synchronize()
        parts["http"] = dict(kernels.LAUNCHES)
    finally:
        srv.stop()
    del eng
    res["http"] = {"tokens": by_text.get("tokens"),
                   "text": by_text.get("text"),
                   "seconds": time.perf_counter() - t0}
    if by_text.get("error") is not None or not by_text.get("tokens") \
            or by_text["tokens"] != by_ids.get("tokens") \
            or by_text.get("text") != tk.decode(by_text["tokens"]):
        raise SystemExit(f"path j1: the text request failed: {by_text}, "
                         f"ids: {by_ids}")
    require_launches("j1 HTTP", parts["http"],
                     ("matmul_q4_0_mma", "flash_attn", "attn_decode"))
    counts = {k: sum(p[k] for p in parts.values()) for k in kernels.LAUNCHES}
    res["launches"] = {p: {k: v for k, v in c.items() if v}
                       for p, c in parts.items()}
    emit({"io_gguf_path": res})
    return res, counts


def hf_gpt2_tensors(params):
    """A GPT-2 tree in HF's safetensors layout: QTensors dequantized to F32
    (Conv1D weights transposed to [in, out]), the other leaves as they are
    (bf16 for path c's tree)."""
    from ggmlsharp_tpu_torch import dequantize
    from ggmlsharp_tpu_torch.quant.formats import QTensor

    def dense(t):
        return dequantize(t) if isinstance(t, QTensor) else t

    t = {"wte.weight": dense(params["wte"]), "wpe.weight": params["wpe"],
         "ln_f.weight": params["ln_f"]["g"], "ln_f.bias": params["ln_f"]["b"]}
    for i, b in enumerate(params["blocks"]):
        p = f"h.{i}."
        for part in ("ln_1", "ln_2"):
            t[f"{p}{part}.weight"] = b[part]["g"]
            t[f"{p}{part}.bias"] = b[part]["b"]
        for mod, w, hf in (("attn", "c_attn", "attn.c_attn"),
                           ("attn", "c_proj", "attn.c_proj"),
                           ("mlp", "c_fc", "mlp.c_fc"),
                           ("mlp", "c_proj", "mlp.c_proj")):
            t[f"{p}{hf}.weight"] = dense(b[mod][f"{w}_w"]).t().contiguous()
            t[f"{p}{hf}.bias"] = b[mod][f"{w}_b"]
    return t


def write_safetensors(path, tensors):
    """The safetensors format, written without the safetensors package: an
    8-byte little-endian header length, a JSON header padded with spaces to
    8 bytes, each tensor's bytes in turn. Returns the file's size."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
    return 8 + len(hb) + off


def dense_gpt2_tree(params):
    """The GPT-2 tree with every QTensor dequantized to f32 (the port's
    [out, in] layout)."""
    from ggmlsharp_tpu_torch import dequantize
    from ggmlsharp_tpu_torch.quant.formats import QTensor

    def walk(x):
        if isinstance(x, QTensor):
            return dequantize(x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(params)


def run_hf_path(smi, cfg, params, prompt):
    """Path j2: path c's GPT-2 124M weights (its Q8_0 matrices dequantized
    to F32, its bf16 norms, biases and wpe as BF16) written in HF's layout
    by write_safetensors, loaded onto the card by load_hf_gpt2 and
    quantized to Q8_0 there. The result must be, bit for bit, the Q8_0 tree
    quantize_params makes of the same f32 weights in memory, and give its
    tokens and prompt logits through path c's route (its launches of
    kernels 4, 8 and 11). Requantizing dequantized Q8_0 moves a block's
    scale unless the block holds a ±127, so path c's own tokens are reported
    beside them, not required."""
    import shutil

    import torch

    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.io import load_hf_gpt2
    from ggmlsharp_tpu_torch.models import gpt2, sampling

    tensors = hf_gpt2_tensors(params)
    need = sum(t.numel() * t.element_size() for t in tensors.values())
    d = scratch_dir(need)
    path = os.path.join(d, "model.safetensors")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        size = write_safetensors(path, tensors)
        write_s = time.perf_counter() - t0
        del tensors
        t0 = time.perf_counter()
        hcfg, loaded = load_hf_gpt2(path, config={"n_head": cfg.n_head})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if hcfg != cfg:
        raise SystemExit(f"path j2: loaded config {hcfg} != {cfg}")
    t0 = time.perf_counter()
    q = gpt2.quantize_params(loaded, GType.Q8_0)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del loaded
    ref = gpt2.quantize_params(dense_gpt2_tree(params), GType.Q8_0)
    diffs = bit_diffs(q, ref)
    if diffs:
        raise SystemExit(f"path j2: the loaded tree differs at {diffs[:8]}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks, _ = sampling.generate(gpt2.forward, cfg, q, prompt,
                                gpt2.new_cache(cfg, 1), N_NEW)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    expect_launches("j2 generate", counts, gpt2_b1_launches(cfg))
    ref_toks, _ = sampling.generate(gpt2.forward, cfg, ref, prompt,
                                    gpt2.new_cache(cfg, 1), N_NEW)
    logits_equal = bool(torch.equal(prompt_logits(gpt2, cfg, q, prompt),
                                    prompt_logits(gpt2, cfg, ref, prompt)))
    res = {"card": smi, "file_bytes": size, "write_s": write_s,
           "write_gb_s": size / write_s / 1e9, "load_s": load_s,
           "load_gb_s": size / load_s / 1e9, "quantize_s": quant_s,
           "generate_s": generate_s,
           "page_cache": "warm: the load reads the file just written",
           "tokens": toks[0].tolist(),
           "tokens_equal_in_memory_route": bool(torch.equal(toks, ref_toks)),
           "prompt_logits_bit_equal": logits_equal,
           "launches": {k: v for k, v in counts.items() if v}}
    emit({"io_hf_path": res})
    if not (res["tokens_equal_in_memory_route"] and logits_equal):
        raise SystemExit(f"path j2: the loaded model differs: {res}")
    if len(set(res["tokens"])) < N_NEW // 2:
        raise SystemExit(f"path j2: the greedy stream collapsed: {res}")
    return res, counts


def run_checkpoint_path(smi, dev, train_state):
    """Path j3: path g's parameters after its Adam steps through
    save_checkpoint and load_checkpoint: every leaf bit for bit (bf16 kept)
    and the training loss on the loaded tree equal to the loss on the
    original; then a small tree of a Q4_0 QTensor, a bf16 vector, a list
    and None, the loaded QTensor's one-row matmul through matmul_q4_0 equal
    to the original's."""
    import shutil

    import torch

    from ggmlsharp_tpu_torch import kernels, ops
    from ggmlsharp_tpu_torch.io import load_checkpoint, save_checkpoint
    from ggmlsharp_tpu_torch.models.llama import random_q4_0
    from ggmlsharp_tpu_torch.optim.tree import tree_leaves

    x, loss, n_layer = train_state
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    need = sum(t.numel() * t.element_size() for t in tree_leaves(x))
    small = {"q": random_q4_0(4096, 4096, gen, dev),
             "g": torch.randn(4096, generator=gen, device=dev).to(
                 torch.bfloat16),
             "lst": [torch.arange(5, device=dev), None], "none": None}
    d = scratch_dir(need + small["q"].nbytes())
    try:
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(d, "g"), x, step=TRAIN_STEPS)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, step = load_checkpoint(os.path.join(d, "g"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        save_checkpoint(os.path.join(d, "s"), small, step=0)
        sback, _ = load_checkpoint(os.path.join(d, "s"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    diffs = bit_diffs(x, back) + bit_diffs(small, sback)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad():
        f0, f1 = float(loss(x)), float(loss(back))
    xr = torch.randn((1, 4096), generator=gen, device=dev)
    y0 = ops.mul_mat(small["q"], xr)
    y1 = ops.mul_mat(sback["q"], xr)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    res = {"card": smi, "leaves": len(tree_leaves(x)), "bytes": need,
           "save_s": save_s, "load_s": load_s, "step": step,
           "loss": f0, "loss_loaded": f1, "bit_diffs": diffs,
           "matmul_equal": bool(torch.equal(y0, y1)),
           "launches": {k: v for k, v in counts.items() if v}}
    emit({"io_checkpoint_path": res})
    if diffs or f0 != f1 or step != TRAIN_STEPS or not res["matmul_equal"]:
        raise SystemExit(f"path j3: the checkpoint did not round-trip: {res}")
    expect_launches("j3", counts, dict.fromkeys(kernels.LAUNCHES, 0) | {
        "flash_attn": 2 * n_layer, "matmul_q4_0": 2})
    return res, counts


# --- speculative decoding and GPT-J (paths k1, k2, k3, l) -------------------

SPEC_K = 4                  # drafts a round on paths k1-k3
K3_SAMPLED = 2              # k3's requests at temperature 0.8
# GPT-J 6B's Q4_0 matmuls: (name, N, K, launches a forward); the LM head
# takes Q8_0 activations (ops.linear's default), as the blocks' do
GPTJ_SHAPES = [("wq_wk_wv_wo", 4096, 4096, 4 * 28), ("fc_in", 16384, 4096, 28),
               ("fc_out", 4096, 16384, 28), ("lm_head", 50400, 4096, 1)]
GPTJ_B = (1, SPEC_K + 1)   # a decode token; a verify's rows
GPTJ_LAYERS = 8  # path l's depth (of 28): cut for the script's time limit


@contextlib.contextmanager
def record_rounds(rounds):
    """models.speculative's make_spec_round(_sampled) wrapped for the block:
    every round made inside it appends (emitted, n_emit) as host arrays to
    ``rounds`` (speculative_generate looks both up in its module when it
    makes its round, and fetches each round's tokens anyway; the engine
    binds them at import and is wrapped per instance in run_spec_engine)."""
    from ggmlsharp_tpu_torch.models import speculative as sp

    orig = sp.make_spec_round, sp.make_spec_round_sampled

    def wrap(make):
        def recording_make(*args, **kw):
            rnd = make(*args, **kw)

            def recorded(*a, **k):
                out = rnd(*a, **k)
                rounds.append((out[0].cpu().numpy(), out[1].cpu().numpy()))
                return out
            return recorded
        return recording_make

    sp.make_spec_round, sp.make_spec_round_sampled = (wrap(f) for f in orig)
    try:
        yield
    finally:
        sp.make_spec_round, sp.make_spec_round_sampled = orig


def plain_gaps(model, cfg, params, prompt, toks, **cache_kw):
    """Top-2 gaps [n] of the plain route's logits that choose toks[0, :n]:
    ONE plain forward over prompt + toks (the same per-row function a
    prefill and its decode steps compute, in another summation order)."""
    import functools

    import torch

    seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
    S = seq.shape[1]
    with torch.inference_mode():
        lg, _ = functools.partial(model.forward, plain=True)(
            params, cfg, seq, model.new_cache(cfg, 1, **cache_kw),
            torch.arange(S, dtype=torch.int32, device=seq.device)[None],
            prefix_bound=S)
    top2 = lg[0, prompt.shape[1] - 1:].float().topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu()


def held_to_reference(got, want, gaps, tol):
    """got vs want token lists where gaps (the plain top-2 gap at each of
    want's positions) exceeds 2 * tol: the index of the first parting (None
    if none), and whether it fell on a decided position."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return j, bool(gaps[j] > 2 * tol)
    return None, False


def spec_launches(cfg, kind, rounds, d_cfg=None):
    """Expected launches of speculative_generate at b = 1 (k1: Llama Q4_0,
    draft = target; k2: GPT-2 Q8_0 with a GPT-2 draft) for ``rounds``
    rounds after a 16-token prompt."""
    from ggmlsharp_tpu_torch import kernels

    want = dict.fromkeys(kernels.LAUNCHES, 0)
    if kind == "llama":
        n = 4 * cfg.n_layer + 1  # the matmuls of a forward
        # target and draft prefill (16 and 15 rows), each round the draft's
        # 2-row seed prefill and 5-row verify (multi-row), k - 1 draft steps
        return want | dq_launches("matmul_q4_0", n * (2 + 2 * rounds),
                                  n * (SPEC_K - 1) * rounds) | {
            "flash_attn": 2 * cfg.n_layer}
    Lt, Ld = cfg.n_layer, d_cfg.n_layer
    return want | {
        # c_attn, c_proj a block and the LM head: both prefills, each
        # round's 2-row draft seed and 5-row verify; draft steps: the LM
        # head at one row after the whole-block kernel
        **dq_launches("matmul_q8_0", (2 * Lt + 1 + 2 * Ld + 1) * (1 + rounds),
                      (SPEC_K - 1) * rounds),
        **dq_launches("mlp_fused_q8", (Lt + Ld) * (1 + rounds), 0),
        "gpt2_layer": Ld * (SPEC_K - 1) * rounds,
        "flash_attn": Lt + Ld}


def spec_forms(run, forms=("eager", "captured")):
    """run() in the eager form (captured.disabled()), then as the port runs
    it (its rounds captured), the launch counters and capture counts reset
    just before each and read just after: {form: (run()'s result,
    launches, captured.COUNTS, seconds)}."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured

    out = {}
    for form in forms:
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            torch.cuda.synchronize()
            kernels.reset_launches()
            captured.reset_counts()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            out[form] = (res, dict(kernels.LAUNCHES), dict(captured.COUNTS),
                         time.perf_counter() - t0)
    return out


def form_record(forms, n_tokens):
    """The per-form figures of spec_forms' output: seconds, tok/s and the
    captured form's captures, replays and capture seconds."""
    return {form: {"seconds": secs, "tok_s": n_tokens / secs, **counts}
            for form, (_, _, counts, secs) in forms.items()}


def run_spec_k1(smi, cfg, params, prompt, toks_a):
    """Path k1: Llama-7B Q4_0 speculative decode at b = 1, draft = target,
    bf16 head-major caches, k = SPEC_K: the 16-token prompt and N_NEW tokens,
    in both forms (eager, then the rounds captured: one graph a length
    bucket). The captured form's tokens and launches must equal the eager
    form's; its tokens must equal path a's greedy tokens on every decided
    position up to the first undecided one (decided: the plain top-2 gap
    above 2 * 0.1, path a's tol), every round whose k drafts are all
    decided must emit k + 1, and the launches must be the rounds'
    (multi-row and b = 1 Q4_0 instances). Phase 6 times the round
    (spec_round_forms)."""
    import torch

    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.models.speculative import speculative_generate

    tol = 0.1

    def run():
        rounds = []
        with record_rounds(rounds):
            toks, rate = speculative_generate(
                llama.forward, cfg, params, llama.forward, cfg, params,
                prompt, llama.new_cache(cfg, 1), llama.new_cache(cfg, 1),
                N_NEW, k=SPEC_K)
        return toks, rate, rounds

    forms = spec_forms(run)
    (toks, rate, rounds), counts, _, seconds = forms["captured"]
    (e_toks, _, _), e_counts, _, _ = forms["eager"]
    # a second call with new caches: the graph cache's graphs, no capture
    again = spec_forms(run, ("captured",))["captured"]
    (a_toks, _, _), a_counts, a_cap, a_secs = again
    want = spec_launches(cfg, "llama", len(rounds))
    gaps = plain_gaps(llama, cfg, params, prompt, toks_a)
    got, ref = toks[0].tolist(), toks_a[0].tolist()
    part, part_decided = held_to_reference(got, ref, gaps, tol)
    end = N_NEW if part is None else part
    # round r's drafts predict positions e .. e + k - 1 (a0 is position 0)
    full_ok, checked, e = True, 0, 1
    for _, ne in rounds:
        pos = range(e, e + SPEC_K)
        if pos[-1] < end and all(gaps[p] > 2 * tol for p in pos):
            checked += 1
            full_ok &= int(ne[0]) == SPEC_K + 1
        e += int(ne[0])
    res = {"card": smi, "k": SPEC_K, "tokens": got, "rounds": len(rounds),
           "n_emit": [int(ne[0]) for _, ne in rounds],
           "mean_tokens_a_round": rate, "seconds": seconds,
           "tok_s": N_NEW / seconds, "forms": form_record(forms, N_NEW),
           "eager_tokens_equal": bool(torch.equal(toks, e_toks)),
           "eager_launches_equal": counts == e_counts,
           "tokens_equal_path_a": sum(a == b for a, b in zip(got, ref)),
           "first_parting": part, "parting_decided": part_decided,
           "tokens_decided": int((gaps > 2 * tol).sum()),
           "all_decided_rounds": checked, "all_decided_rounds_emit_k1": full_ok,
           "launches": counts, "expected_launches": want,
           "second_call": {"seconds": a_secs, "tok_s": N_NEW / a_secs,
                           **a_cap, "tokens_equal": bool(torch.equal(
                               a_toks, toks)),
                           "launches_equal": a_counts == counts}}
    emit({"spec_llama_k1": res})
    expect_launches("k1", counts, want)
    if a_cap["captures"] or not (res["second_call"]["tokens_equal"]
                                 and res["second_call"]["launches_equal"]):
        raise SystemExit(f"path k1: a second call captured or differs: "
                         f"{res['second_call']}")
    require_launches("k1", counts, ("matmul_q4_0", "matmul_q4_0_mma"))
    if not (res["eager_tokens_equal"] and res["eager_launches_equal"]):
        raise SystemExit(f"path k1: the captured rounds differ from their "
                         f"eager twin: {e_toks.tolist()} vs {got}, launches "
                         f"{e_counts} vs {counts}")
    if part_decided or not full_ok or toks.shape != (1, N_NEW):
        raise SystemExit(f"path k1: speculative tokens disagree: {res}")
    return res, counts


def run_spec_k2(smi, t_cfg, t_params, d_cfg, d_params, prompt):
    """Path k2: GPT-2 774M Q8_0 target, GPT-2 124M Q8_0 draft, b = 1, flat
    float caches, each run in both forms (eager, then captured), tokens and
    launches equal: greedy, held on decided positions to the 774M target's
    own per-op greedy decode (GGML_TPU_LAYER_FUSED=0 for that reference
    only: the whole-block kernel quantizes no activation, the verify's
    per-op route does, so path c computes another function); then one
    rejection-sampled run (temperature 0.8, top-p 0.95, a generator seeded
    alike in both forms: the captured round registers it with its graph,
    and the captured stream must equal the eager one token for token)."""
    import torch

    from ggmlsharp_tpu_torch.models import gpt2, sampling
    from ggmlsharp_tpu_torch.models.speculative import speculative_generate

    tol = 0.1  # path c's, under the same settings
    dev = prompt.device

    def caches():
        t, d = gpt2.new_cache(t_cfg, 1), gpt2.new_cache(d_cfg, 1)
        if not (t.is_flat and d.is_flat):
            raise SystemExit("path k2 must run over flat float caches")
        return t, d

    def run(**kw):
        rounds = []
        with record_rounds(rounds):
            toks, rate = speculative_generate(
                gpt2.forward, t_cfg, t_params, gpt2.forward, d_cfg, d_params,
                prompt, *caches(), N_NEW, k=SPEC_K, **kw)
        return toks, rate, rounds

    forms = spec_forms(run)
    (toks, rate, rounds), counts, _, seconds = forms["captured"]
    (e_toks, _, _), e_counts, _, _ = forms["eager"]
    want = spec_launches(t_cfg, "gpt2", len(rounds), d_cfg)
    os.environ["GGML_TPU_LAYER_FUSED"] = "0"
    try:
        cache = gpt2.new_cache(t_cfg, 1)
        if cache.is_flat:
            raise SystemExit("GGML_TPU_LAYER_FUSED=0 left the cache flat")
        ref, _ = sampling.generate(gpt2.forward, t_cfg, t_params, prompt,
                                   cache, N_NEW)
        gaps = plain_gaps(gpt2, t_cfg, t_params, prompt, ref)
    finally:
        os.environ.pop("GGML_TPU_LAYER_FUSED")
    got, want_toks = toks[0].tolist(), ref[0].tolist()
    part, part_decided = held_to_reference(got, want_toks, gaps, tol)
    s_forms = spec_forms(lambda: run(
        temperature=0.8, top_p=0.95,
        rng=torch.Generator(dev).manual_seed(SEED)))
    (s_toks, s_rate, s_rounds), s_counts, _, _ = s_forms["captured"]
    (se_toks, _, _), se_counts, _, _ = s_forms["eager"]
    s_emit = [int(ne[0]) for _, ne in s_rounds]
    res = {"card": smi, "k": SPEC_K, "target": "GPT-2 774M", "draft":
           "GPT-2 124M", "tokens": got, "rounds": len(rounds),
           "n_emit": [int(ne[0]) for _, ne in rounds],
           "mean_tokens_a_round": rate, "seconds": seconds,
           "tok_s": N_NEW / seconds, "forms": form_record(forms, N_NEW),
           "eager_tokens_equal": bool(torch.equal(toks, e_toks)),
           "eager_launches_equal": counts == e_counts,
           "reference_per_op_tokens": want_toks,
           "tokens_equal_reference": sum(a == b for a, b in
                                         zip(got, want_toks)),
           "first_parting": part, "parting_decided": part_decided,
           "tokens_decided": int((gaps > 2 * tol).sum()),
           "sampled": {"tokens": s_toks[0].tolist(), "n_emit": s_emit,
                       "mean_tokens_a_round": s_rate,
                       "forms": form_record(s_forms, N_NEW),
                       "eager_tokens": se_toks[0].tolist(),
                       "eager_tokens_equal": bool(torch.equal(s_toks,
                                                              se_toks)),
                       "eager_launches_equal": s_counts == se_counts},
           "launches": counts, "expected_launches": want}
    emit({"spec_gpt2_k2": res})
    expect_launches("k2", counts, want)
    require_launches("k2", counts, ("gpt2_layer", "matmul_q8_0_mma",
                                    "mlp_fused_q8_mma"))
    if not (res["eager_tokens_equal"] and res["eager_launches_equal"]):
        raise SystemExit(f"path k2: the captured rounds differ from their "
                         f"eager twin: {res}")
    if part_decided or toks.shape != (1, N_NEW):
        raise SystemExit(f"path k2: speculative tokens disagree: {res}")
    if s_toks.shape != (1, N_NEW) or not all(1 <= n <= SPEC_K + 1
                                              for n in s_emit) \
            or int(s_toks.min()) < 0 or int(s_toks.max()) >= t_cfg.n_vocab:
        raise SystemExit(f"path k2: the sampled run is malformed: {res}")
    if s_forms["captured"][2]["captures"] < 1 \
            or not res["sampled"]["eager_tokens_equal"]:
        raise SystemExit(f"path k2: the sampled rounds were not captured, "
                         f"or their stream differs from the eager one: "
                         f"{res['sampled']}")
    return res, counts


def k3_requests(cfg):
    """k3's traffic: path b's 24 greedy prompts (the first carrying a
    registered prefix of its first 8 tokens) and K3_SAMPLED requests at
    temperature 0.8."""
    import numpy as np

    from ggmlsharp_tpu_torch.serving import Request

    prompts = serving_prompts(cfg)
    rng = np.random.default_rng(13)
    extra = [rng.integers(0, cfg.n_vocab, size=SERVE_PLEN).tolist()
             for _ in range(K3_SAMPLED)]
    prefix = prompts[0][:8]

    def reqs(pid):
        out = [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW,
                       prefix_id=pid if i == 0 else None)
               for i, p in enumerate(prompts)]
        return out + [Request(id=len(prompts) + j, prompt=p,
                              max_new_tokens=SERVE_NEW, temperature=0.8)
                      for j, p in enumerate(extra)]
    return prefix, reqs


def run_spec_engine(cfg, params, forward, prefix, reqs, record=False):
    """A speculative engine (draft = target, INT8 flat caches, SLOTS slots)
    over k3's traffic with ``forward`` for both models. record: keep, for
    every emitted greedy token, the top-2 gap of the logits that chose it
    (the verify's row, or the slot's last logits for a0)."""
    import torch

    from ggmlsharp_tpu_torch.serving import Engine

    gaps: dict = {}
    slot_rounds = []  # (live slot-rounds, tokens they emitted)
    last = {}

    def gap_of(lg):
        top2 = lg.float().topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]).cpu()

    def rec_forward(p, c, toks, cache, pos, **kw):
        out = forward(p, c, toks, cache, pos, **kw)
        if kw.get("cached_prefix") and toks.shape[1] == SPEC_K + 1:
            last["verify"] = out[0]  # the target's verify: drafts never
        return out                   # call with k + 1 tokens

    def wrap_round(rnd):
        def recorded(*a, **kw):
            out = rnd(*a, **kw)
            ne = out[1].cpu().numpy()
            live = [(i, r) for i, r in enumerate(eng.slots)
                    if r is not None and i not in eng._spec_chunking]
            slot_rounds.append((len(live), sum(int(ne[i]) for i, _ in live)))
            if record:
                g = gap_of(last["verify"])
                for i, r in live:
                    n0 = len(r.out_tokens)
                    for j in range(int(ne[i])):
                        gaps.setdefault(r.id, {})[n0 + j] = float(g[i, j])
            return out
        return recorded

    # the target's forward records its verify logits; the draft's does not
    eng = Engine(rec_forward if record else forward, cfg, params,
                 batch_slots=SLOTS, max_len=SERVE_MAX_LEN, int8_kv=True,
                 cache_dtype=torch.bfloat16, draft_forward=forward,
                 draft_cfg=cfg, draft_params=params, spec_k=SPEC_K)
    if not (eng.cache.is_flat and eng.d_cache.int8 and eng.d_cache.is_flat):
        raise SystemExit("path k3 must run over INT8 flat caches")
    eng._spec_round = wrap_round(eng._spec_round)
    eng._spec_round_sampled = wrap_round(eng._spec_round_sampled)
    if record:
        emit_ = eng._emit

        def first_gap(req, tok):
            if not req.out_tokens and req.temperature <= 0:
                i = eng.slots.index(req)
                gaps.setdefault(req.id, {})[0] = float(
                    gap_of(eng._last_logits[i]))
            emit_(req, tok)
        eng._emit = first_gap
    pid = eng.register_prefix(prefix)
    for r in reqs(pid):
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    return eng, results, time.perf_counter() - t0, gaps, slot_rounds


def run_spec_serving_k3(smi, cfg, params, path_b_tokens):
    """Path k3: speculative serving over path b's config (Llama-7B Q4_0,
    INT8 flat caches, SLOTS slots, draft = target, k = SPEC_K): 24 greedy
    requests of 16 + 24 tokens (one through a registered prefix) and
    K3_SAMPLED at temperature 0.8, the counters reset just before. The gate:
    the engine with kernels equals the same engine with plain forwards on
    decided tokens (each greedy request up to its first parting, which must
    fall where the plain top-2 gap is at most 2 * 0.1, the replay's tol).
    The engine runs in both forms (eager, then captured: its rounds and
    admissions one graph a key), every request's tokens and the launches
    equal. Reported, not gated: the share of greedy tokens equal to path
    b's (over an INT8 flat cache a single-token step attends its fresh row
    unquantized, the verify its rows quantized: other functions), the mean
    tokens a round. Then an HTTP check over EngineServer on the engine."""
    import functools

    import torch

    from ggmlsharp_tpu_torch.models import captured, llama

    tol = 0.1
    prefix, reqs = k3_requests(cfg)
    forms = spec_forms(lambda: run_spec_engine(cfg, params, llama.forward,
                                               prefix, reqs))
    (eng, got, seconds, _, rounds), counts, _, _ = forms["captured"]
    (e_eng, e_got, _, _, _), e_counts, _, _ = forms["eager"]
    del e_eng
    st = eng.stats()
    with captured.disabled():  # the reference: plain forwards, eager
        _, ref, _, gaps, _ = run_spec_engine(
            cfg, params, functools.partial(llama.forward, plain=True),
            prefix, reqs, record=True)
    n_greedy = len(path_b_tokens)
    partings, bad = {}, []
    for g, r in zip(got[:n_greedy], ref[:n_greedy]):
        if g.error is not None or len(g.out_tokens) != SERVE_NEW:
            bad.append(g.id)
            continue
        for j, (a, b) in enumerate(zip(g.out_tokens, r.out_tokens)):
            if a != b:
                decided = gaps[r.id][j] > 2 * tol
                partings[g.id] = {"at": j, "plain_gap": gaps[r.id][j]}
                if decided:
                    bad.append(g.id)
                break
    sampled = got[n_greedy:]
    if any(s.error is not None or len(s.out_tokens) != SERVE_NEW
           or not all(0 <= t < cfg.n_vocab for t in s.out_tokens)
           for s in sampled):
        bad += [s.id for s in sampled]
    same_b = sum(a == b for g, bt in zip(got, path_b_tokens)
                 for a, b in zip(g.out_tokens, bt))
    live, emitted = map(sum, zip(*rounds)) if rounds else (0, 0)
    n_out = sum(len(r.out_tokens) for r in got)
    res = {"card": smi, "slots": SLOTS, "k": SPEC_K,
           "requests": len(got), "seconds": seconds,
           "tokens_per_s": n_out / seconds,
           "forms": form_record(forms, n_out),
           "eager_tokens_equal": [r.out_tokens for r in got]
           == [r.out_tokens for r in e_got],
           "eager_launches_equal": counts == e_counts,
           "stats": st, "rounds": len(rounds),
           "mean_tokens_a_round": emitted / max(1, live),
           "partings_from_plain_engine": partings,
           "tokens_equal_plain_engine": sum(
               a == b for g, r in zip(got, ref)
               for a, b in zip(g.out_tokens, r.out_tokens)),
           "greedy_tokens": n_greedy * SERVE_NEW,
           "share_equal_path_b": same_b / (n_greedy * SERVE_NEW),
           "launches": counts}
    emit({"spec_serving_k3": res})
    require_launches("k3", counts, ("matmul_q4_0_mma", "flash_attn",
                                    "attn_decode"))
    if not (res["eager_tokens_equal"] and res["eager_launches_equal"]):
        raise SystemExit(f"path k3: the captured engine differs from its "
                         f"eager twin: {res}")
    if bad or len(got) != n_greedy + K3_SAMPLED:
        raise SystemExit(f"path k3: requests {bad} disagree or failed: {res}")
    http = http_check(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    return res, counts, http


def spec_round_forms(smi, cfg, params, prompt, n_warm=2, n_lat=12):
    """Path k1's round (Llama-7B Q4_0, draft = target, k = SPEC_K, bf16
    head-major caches after the 16-token prompt) in both forms, each from
    the same prefilled caches: host ms a round (synced; median and p84 of
    n_lat rounds after n_warm, which hold the captured form's capture; the
    eager form, ~13x slower, half as many of each),
    device ms and kernels a round (profile_steps over one round), the idle
    share, tokens a round (the timed rounds' mean) and steady tok/s (tokens
    a round over the median round ms); captures and capture seconds apart.
    Both forms must emit the same tokens."""
    import torch

    from ggmlsharp_tpu_torch.models import captured, llama
    from ggmlsharp_tpu_torch.models.sampling import length_bucket
    from ggmlsharp_tpu_torch.models.speculative import make_spec_round

    res, streams = {}, {}
    for form in ("eager", "captured"):
        tc, dc = llama.new_cache(cfg, 1), llama.new_cache(cfg, 1)
        pos = torch.arange(PROMPT_LEN, dtype=torch.int32,
                           device=prompt.device)[None]
        bound = length_bucket(PROMPT_LEN, cfg.n_ctx)
        with torch.no_grad():
            lg, out = llama.forward(params, cfg, prompt, tc, pos,
                                    prefix_bound=bound)
            tc.length.copy_(out.length)
            _, out = llama.forward(params, cfg, prompt[:, :-1], dc,
                                   pos[:, :-1], prefix_bound=bound)
            dc.length.copy_(out.length)
        a0 = torch.argmax(lg[:, -1], -1, keepdim=True).to(torch.int32)
        rnd = make_spec_round(llama.forward, cfg, llama.forward, cfg, SPEC_K)
        state = {"seed": torch.cat([prompt[:, -1:], a0], 1),
                 "h": PROMPT_LEN, "out": []}

        def one_round():
            t_eff = length_bucket(state["h"] + SPEC_K + 2, cfg.n_ctx)
            em, ne, _, _, seed = rnd(params, params, tc, dc, state["seed"],
                                     t_eff=t_eff, d_eff=t_eff)
            state["seed"] = seed.clone()
            state["out"].append(torch.cat([em, ne[:, None]], 1).clone())
            state["h"] += SPEC_K + 1

        captured.reset_counts()
        warm, timed = (max(1, n_warm // 2), max(2, n_lat // 2)) \
            if form == "eager" else (n_warm, n_lat)
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            lat = []
            for i in range(warm + timed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one_round()
                torch.cuda.synchronize()
                if i >= warm:
                    lat.append(time.perf_counter() - t0)
            counts = dict(captured.COUNTS)
            prof = profile_steps(one_round, 1)  # ~27k kernels a round
        rows = torch.cat(state["out"]).cpu()
        streams[form] = rows
        lat_ms = sorted(x * 1e3 for x in lat)
        med = statistics.median(lat_ms)
        per_round = float(rows[warm:warm + timed, -1].float().mean())
        dev_ms = prof["device_ms_per_step"]
        res[form] = {"round_ms_median": med,
                     "round_ms_p84": lat_ms[int(0.84 * len(lat_ms))],
                     "rounds_timed": len(lat_ms),
                     "device_ms_per_round": dev_ms,
                     "kernels_per_round": prof["kernels_per_step"],
                     "aten_calls_per_round": prof["aten_calls_per_step"],
                     "device_idle_share": (1.0 - dev_ms / med
                                           if isinstance(dev_ms, float)
                                           else "not measured"),
                     "tokens_a_round": per_round,
                     "steady_tok_s": per_round * 1e3 / med, **counts}
    res["card"] = smi
    n = min(len(r) for r in streams.values())  # the rounds both forms ran
    res["tokens_equal"] = bool(torch.equal(streams["eager"][:n],
                                           streams["captured"][:n]))
    res["speedup_round_ms"] = (res["eager"]["round_ms_median"]
                               / res["captured"]["round_ms_median"])
    emit({"spec_round_k1": res})
    if not res["tokens_equal"]:
        raise SystemExit("k1's captured rounds emit other tokens than its "
                         "eager rounds")
    return res


def serving_waves(smi, cfg, params, want):
    """Path b's traffic (SERVE_REQS requests of SERVE_PLEN + SERVE_NEW
    tokens, SLOTS slots, INT8 flat cache) twice on one engine, captured:
    each wave's mean and median TTFT (first token - submit), mean latency,
    seconds and tok/s, and the captures and capture seconds it made (the
    first wave captures its admissions and decode steps; the second finds
    them made). The eager form's wave is phase 4 b's. Both waves must give
    ``want``, phase 4 b's tokens (equal in both forms)."""
    import torch

    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.serving import Request

    prompts = serving_prompts(cfg)
    waves, outs = [], []
    eng = new_engine(cfg, params)
    for _ in range(2):
        captured.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(id=i, prompt=p, max_new_tokens=SERVE_NEW))
        got = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ttft = [r.t_first_token - r.t_submit for r in got]
        outs.append([r.out_tokens for r in got])
        waves.append({"mean_ttft_s": statistics.mean(ttft),
                      "median_ttft_s": statistics.median(ttft),
                      "mean_latency_s": statistics.mean(
                          [r.t_done - r.t_submit for r in got]),
                      "seconds": secs,
                      "tokens_per_s": SERVE_REQS * SERVE_NEW / secs,
                      **dict(captured.COUNTS)})
    del eng
    torch.cuda.empty_cache()
    res = {"card": smi, "captured": waves,
           "tokens_equal": all(o == want for o in outs)}
    emit({"serving_waves": res})
    if not res["tokens_equal"]:
        raise SystemExit("serving waves: a wave's tokens differ from phase "
                         "4 b's")
    return res


ADMIT_BUCKETS = (16, 64, 256)  # single admissions (256: a 200-token prompt)
ADMIT_GROUPS = ((16, SLOTS), (64, SLOTS), (16, 3))  # (bucket, requests)


def admission_ms(smi, cfg, params, reps=5):
    """The engine's admission prefill on path b's engine, in each form:
    a single admission into slot 0 at each of ADMIT_BUCKETS (a prompt of
    the bucket's length, 200 tokens for 256), and a grouped admission of
    each of ADMIT_GROUPS (3 requests pad to a group of 4): the first call
    (the captured form's capture) apart, then the median and p84 host ms
    of ``reps`` synced calls; captures and capture seconds."""
    import numpy as np
    import torch

    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.serving import Request

    rng = np.random.default_rng(5)
    res = {}
    for form in ("eager", "captured"):
        rows = []
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            eng = new_engine(cfg, params)
            cases = [("single", b, 1) for b in ADMIT_BUCKETS] + \
                [("group", b, n) for b, n in ADMIT_GROUPS]
            for kind, bucket, n in cases:
                plen = min(bucket, 200)
                reqs = [Request(id=i, prompt=rng.integers(
                    0, cfg.n_vocab, plen).tolist(), max_new_tokens=1)
                    for i in range(n)]

                def call():
                    if kind == "single":
                        eng._prefill_slot(reqs[0], 0)
                    else:
                        eng._prefill_many(bucket, [(r, i) for i, r in
                                                   enumerate(reqs)],
                                          lambda r: r.prompt)

                captured.reset_counts()
                ms = []
                for _ in range(1 + reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                steady = sorted(ms[1:])
                rows.append({"kind": kind, "bucket": bucket, "requests": n,
                             "first_ms": ms[0],
                             "ms_median": statistics.median(steady),
                             "ms_p84": steady[int(0.84 * len(steady))],
                             **dict(captured.COUNTS)})
            del eng
            torch.cuda.empty_cache()
        res[form] = rows
    res["card"] = smi
    emit({"admission_prefill": res})
    return res


def gptj_weight_bytes(params):
    """Q4_0 bytes a GPT-J decode token reads once: six matrices a block and
    the LM head (wte serves one row a token)."""
    return params["lm_head"]["w"].nbytes() + sum(
        blk[g][k].nbytes() for blk in params["blocks"]
        for g, k in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                     ("attn", "wo"), ("mlp", "fc_in_w"), ("mlp", "fc_out_w")))


def dense_as(tree, dtype):
    """The tree with every dense tensor leaf cast to ``dtype`` (a GGUF
    stores them as F32; the synthetic tree holds them in bf16, so the cast
    back is exact)."""
    import torch

    if isinstance(tree, dict):
        return {k: dense_as(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dense_as(v, dtype) for v in tree]
    return tree.to(dtype) if isinstance(tree, torch.Tensor) else tree


def run_gptj_path(smi, dev, gen):
    """Path l: GPT-J 6B (full width, depth cut to GPTJ_LAYERS of its 28
    layers: the script's time limit) Q4_0 at b = 1, random weights
    quantized on the card from the seed, bf16 head-major cache: the 16-token
    prompt (kernel 1's multi-row instance, flash at D 256) and N_NEW greedy
    tokens (kernel 1 at one row, einsum attention), counters reset just
    before; held against its plain route; then a GGUF round trip of the
    whole tree (leaves bit for bit, the same tokens); tok/s and the share of
    the HBM roofline."""
    import dataclasses

    import numpy as np
    import torch

    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.io import load_gguf_gptj, save_gguf_gptj
    from ggmlsharp_tpu_torch.models import gptj, sampling

    cfg = dataclasses.replace(gptj.GPTJ_6B, n_layer=GPTJ_LAYERS)
    t0 = time.perf_counter()
    params = gptj.synthetic_params(cfg, GType.Q4_0, seed=SEED)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.n_vocab, (1, PROMPT_LEN), generator=gen,
                           device=dev, dtype=torch.int32)
    n = 6 * cfg.n_layer + 1
    want = dict.fromkeys(kernels.LAUNCHES, 0) | dq_launches(
        "matmul_q4_0", n, n * N_NEW) | {"flash_attn": cfg.n_layer}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    toks, cache = sampling.generate(gptj.forward, cfg, params, prompt,
                                    gptj.new_cache(cfg, 1), N_NEW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    emit({"gptj_path": {"tokens": toks[0].tolist(), "seconds": seconds,
                        "distinct_tokens": len(set(toks[0].tolist())),
                        "launches": counts, "expected_launches": want}})
    expect_launches("l", counts, want)
    if toks.shape != (1, N_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.n_vocab \
            or int(cache.length[0]) != PROMPT_LEN + N_NEW:
        raise SystemExit(f"path l: bad tokens {toks}")
    # path a's tolerances. The path's own settings (Q8_0 activations, bf16
    # cache rows, and a bf16 stream: the forward casts each block's two
    # branches to the stream's dtype, as JAX's does) round a one-ulp
    # difference by a whole step (measured 0.071 on logits up to 4.5): tol
    # 0.1. Weight-only over an f32 cache with the dense leaves in f32 (an
    # f32 stream) the routes differ in f32 summation order alone: tol 1e-3
    # (with bf16 leaves the stream's rounding alone came to 0.043)
    errs = [compare_plain(gptj, cfg, params, prompt, quant_acts=True,
                          cache_dtype=torch.bfloat16, tol=0.1, toks=toks,
                          route="l"),
            compare_plain(gptj, cfg, dense_as(params, torch.float32), prompt,
                          quant_acts=False, cache_dtype=torch.float32,
                          tol=1e-3, route="l, f32 stream")]
    # the GGUF round trip
    wbytes = gptj_weight_bytes(params)
    d = scratch_dir(wbytes + params["wte"].nbytes() + 2**28)
    path = os.path.join(d, "gptj-6b-q4_0.gguf")
    try:
        t0 = time.perf_counter()
        save_gguf_gptj(path, cfg, params)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        cfg2, loaded = load_gguf_gptj(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        for f in (path,):
            if os.path.exists(f):
                os.remove(f)
        os.rmdir(d)
    eps32 = float(np.float32(cfg.ln_eps))  # the file holds an f32
    if cfg2.ln_eps != eps32 or dataclasses.replace(
            cfg2, ln_eps=cfg.ln_eps) != cfg:
        raise SystemExit(f"path l: the GGUF config {cfg2} != {cfg}")
    loaded = dense_as(loaded, torch.bfloat16)
    diffs = bit_diffs(params, loaded)
    toks2, _ = sampling.generate(gptj.forward, cfg, loaded, prompt,
                                 gptj.new_cache(cfg, 1), N_NEW)
    del loaded
    dec = measure_decode(gptj, cfg, params, prompt, wbytes, cfg.n_embd,
                         n_lat=16, n_win=32, n_prof=4)
    res = {"card": smi, "config": f"GPTJ_6B, {GPTJ_LAYERS} layers",
           "format": "Q4_0",
           "synthetic_s": make_s, "peak_mem_gb": peak / 1e9,
           "vs_plain_max_abs_err": errs, "gguf_bytes": size,
           "gguf_write_gb_s": size / write_s / 1e9,
           "gguf_load_gb_s": size / load_s / 1e9,
           "gguf_leaf_diffs": diffs[:8],
           "gguf_tokens_equal": bool(torch.equal(toks, toks2)),
           "decode": dec}
    emit({"gptj_decode": res})
    if diffs or not res["gguf_tokens_equal"]:
        raise SystemExit(f"path l: the GGUF round trip changed the model: "
                         f"{res}")
    del params
    torch.cuda.empty_cache()
    return res, counts


# --- the eval chain, KV quality, the examples and the last two modules
# (paths m1, m2, n) -----------------------------------------------------------


def check_chain_matmuls(dev, gen):
    """Path m1's quantized matmul: w_down of the chain model (N 192, K 512)
    in Q4_0, Q4_K, Q6_K and Q8_0 through mul_mat_q_fused at 127 rows (a
    perplexity window) and 128, Q8 activations and f32 x in both mm_dot
    modes, against the plain mul_mat_q at check_weight_rows' bar (1e-5 of
    sum_k |x_k| |w|_nk, x as the call rounds it: hold_rows). Returns the
    largest error; raises on a disagreement."""
    import torch

    worst, rows = 0.0, []
    for fmt in ("Q4_0", "Q4_K", "Q6_K", "Q8_0"):
        w = random_weight(fmt, 192, 512, gen, dev)
        wabs = weight_abs_terms(w)
        for b in (127, 128):
            x = torch.randn((b, 512), generator=gen, device=dev)
            for qa, mode in ((True, "f32"), (False, "f32"), (False, "bf16")):
                e, over, ok = hold_rows(w, wabs, x, qa, mode)
                worst = max(worst, e)
                rows.append({"format": fmt, "b": b, "acts": "q8" if qa
                             else "f32", "mm_dot": mode, "max_abs_err": e,
                             "max_err_over_sum_abs": over, "ok": ok})
                if not ok:
                    emit({"chain_matmul_check": rows})
                    raise SystemExit(f"m1 matmul disagrees: {rows[-1]}")
    emit({"chain_matmul_check": rows})
    return worst


def chain_train_check(cfg, toks, dev):
    """m1's training step held against its plain route: the loss and the
    gradient at the seed-0 initial parameters, kernel route (flash at D 32
    under autograd) vs set_kernels(False). f32 throughout: the loss to 1e-5
    relative, each gradient to 1e-3 relative L2 (the flash Function's
    backward is the dense recompute on both routes; the forward's sums
    differ in order)."""
    import torch

    from ggmlsharp_tpu_torch.kernels.config import set_kernels
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.models.common import lm_loss
    from ggmlsharp_tpu_torch.optim import value_and_grad
    from ggmlsharp_tpu_torch.optim.tree import tree_leaves

    p0 = llama.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev, dtype=torch.float32)
    vg = value_and_grad(lambda p: lm_loss(llama.forward, cfg, p, toks))
    fk, gk = vg(p0)
    set_kernels(False)
    try:
        fp, gp = vg(p0)
    finally:
        set_kernels(None)
    loss_err = abs(float(fk) - float(fp)) / abs(float(fp))
    grad_err = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    if not (loss_err <= 1e-5 and grad_err <= 1e-3):
        raise SystemExit(f"m1: training step vs plain: loss rel err "
                         f"{loss_err:.3g}, grad rel L2 {grad_err:.3g}")
    return {"loss_rel_err": loss_err, "grad_rel_l2_max": grad_err}


def chain_step_ms(cfg, toks, dev, form, steps=4):
    """m1's training step (chain.train from the seed-0 parameters) in
    ``form`` ("eager": captured.disabled()): the median host ms of steps
    2..steps (synchronised in the callback), the losses and the captures
    made."""
    import torch

    from ggmlsharp_tpu_torch.eval import chain
    from ggmlsharp_tpu_torch.models import captured, llama

    p0 = llama.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev, dtype=torch.float32)
    stamps, losses = [], []

    def on_step(it, f):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(f)

    captured.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured.disabled() if form == "eager" else contextlib.nullcontext():
        chain.train(cfg, toks, p0, steps, callback=on_step)
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return {"step_ms_median_2_4": statistics.median(step_s[1:]) * 1e3,
            "losses": losses, "captures": captured.COUNTS["captures"]}


def run_chain_m1(smi, repo, dev, workdir):
    """Path m1: scripts/ppl_chain_torch.py's chain for seed 0 at its
    defaults but for the corpus (4L/192E/6 heads/512F, a 512-piece
    vocabulary on make_text(CHAIN_SENT), up to 300 full-batch Adam
    iterations (the chain's eps_f rule may end them sooner)
    over every 128-token chunk of the train third), through eval.chain on
    the card: training
    (flash at D 32 under autograd), the GGUF round trip, held-out perplexity
    at fp32 and in Q8_0, Q4_0, Q4_K and Q6_K (w_down, the one quantized
    matrix, through the dequant-matmuls' multi-row instances at 127 rows),
    Q4_0 and Q4_K also without activation rounding. Checks: the training
    step against its plain route (chain_train_check); the final loss below
    the first; the vocabulary round trip (save_and_reload raises); fp32 and
    Q4_0 perplexity on the plain route over the same file within
    CHAIN_PPL_RTOL; |Q8_0 dppl| < 0.05 ppl_fp (tests/test_eval.py:117);
    kernels 1, 2, 4 and 6 launched."""
    import torch

    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.eval import chain
    from ggmlsharp_tpu_torch.eval.perplexity import perplexity
    from ggmlsharp_tpu_torch.io import load_gguf_llama
    from ggmlsharp_tpu_torch.kernels.config import set_kernels
    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.models import captured, llama

    sys.path.insert(0, os.path.join(repo, "scripts"))
    from gen_corpus import make_text

    t_all = time.perf_counter()
    text = make_text(CHAIN_SENT, seed=chain.CORPUS_SEED)
    tk, ids = chain.tokenize(text, CHAIN_VOCAB)
    toks, half = chain.split(ids)
    cfg = chain.model_config(len(tk.tokens), "small")
    toks_t = torch.as_tensor(toks, device=dev)
    step_check = chain_train_check(cfg, toks_t, dev)
    step_forms = {form: chain_step_ms(cfg, toks_t, dev, form)
                  for form in ("eager", "captured")}
    path = os.path.join(workdir, "ppl_chain_torch_s0.gguf")
    torch.cuda.synchronize()
    kernels.reset_launches()
    captured.reset_counts()
    res = chain.run_seed(0, cfg, toks, CHAIN_STEPS, tk, text, ids, path, dev)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    cap = dict(captured.COUNTS)
    # one training capture, one a perplexity call (fp32 and each format)
    n_ppl = 1 + len(chain.FORMATS) + len(chain.QA_AB)
    if cap["captures"] != 1 + n_ppl or step_forms["eager"]["captures"] \
            or step_forms["captured"]["captures"] != 1 or max(
                abs(a - b) / abs(b) for a, b in zip(
                    step_forms["captured"]["losses"],
                    step_forms["eager"]["losses"])) > 1e-5:
        raise SystemExit(f"m1: captures {cap} (a 4-step run: "
                         f"{step_forms}), want {1 + n_ppl}")
    require_launches("m1", counts, ("matmul_q4_0_mma", "matmul_q_mma",
                                    "matmul_q8_0_mma", "flash_attn"))
    sc = res["scores"]
    ppl_fp = sc["fp32"][0]
    if not res["nll"] < res["nll_start"]:
        raise SystemExit(f"m1: training did not lower the loss: {res}")
    if not abs(sc["Q8_0"] - ppl_fp) < 0.05 * ppl_fp:
        raise SystemExit(f"m1: Q8_0 dppl {sc['Q8_0'] - ppl_fp} past 0.05 of "
                         f"{ppl_fp}")
    # the plain route over the same file
    cfg2, p2 = load_gguf_llama(path, device=dev)
    heldout = ids[half:]
    set_kernels(False)
    try:
        plain_fp, _, _ = perplexity(llama.forward, cfg2, p2, heldout,
                                    chunk_len=chain.S)
        plain_q4, _, _ = perplexity(llama.forward, cfg2,
                                    llama.quantize_params(p2, GType.Q4_0,
                                                          cfg=cfg2),
                                    heldout, chunk_len=chain.S)
    finally:
        set_kernels(None)
    errs = {"fp32": abs(ppl_fp - plain_fp) / plain_fp,
            "Q4_0": abs(sc["Q4_0"] - plain_q4) / plain_q4}
    if max(errs.values()) > CHAIN_PPL_RTOL:
        raise SystemExit(f"m1: perplexity kernel vs plain route {errs}")
    out = {"card": smi, "vocab": len(tk.tokens), "corpus_tokens": len(ids),
           "train_chunks": int(toks.shape[0]), "steps": res["iters"],
           "nll_start": res["nll_start"], "nll": res["nll"],
           "train_s": res["train_s"],
           "step_ms": res["train_s"] / res["iters"] * 1e3,
           "ppl_fp32": ppl_fp, "scored": sc["fp32"][1],
           "dppl": {k: v - ppl_fp for k, v in sc.items() if k != "fp32"},
           "plain_ppl": {"fp32": plain_fp, "Q4_0": plain_q4},
           "ppl_rel_err_vs_plain": errs, "train_step_vs_plain": step_check,
           "step_ms_median_2_4": step_forms["captured"]["step_ms_median_2_4"],
           "eager_step_ms_median_2_4":
               step_forms["eager"]["step_ms_median_2_4"],
           "captures": cap["captures"], "replays": cap["replays"],
           "capture_s": cap["capture_s"],
           "seconds": time.perf_counter() - t_all}
    emit({"chain_m1": out})
    return out, counts, (path, text)


def run_kvq_m2(smi, dev, path, text):
    """Path m2: scripts/kv_quality_torch.py over m1's GGUF: 96 chunks of the
    held-out ids, 127 teacher-forced steps each through an f32 head-major
    cache, a bf16 flat one and an int8 flat one (attn_decode at D 32, B 96,
    E_kv 192), each cache's step one captured graph (eval.kv_quality), then
    the same three in the eager form (captured.disabled()): every row's ppl
    equal within KVQ_FORMS_RTOL and its argmax agreement equal, the ms a
    step of both forms recorded; then the two flat caches on the plain
    route (set_kernels(False)), each decode ppl within KVQ_PPL_RTOL of its
    kernel route's; kernel 3 launched on the kernel route."""
    import numpy as np
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.eval import chain, kv_quality
    from ggmlsharp_tpu_torch.io import (GGUFReader, load_gguf_llama,
                                        tokenizer_from_gguf)
    from ggmlsharp_tpu_torch.kernels.config import set_kernels
    from ggmlsharp_tpu_torch.models import captured

    t0 = time.perf_counter()
    cfg, params = load_gguf_llama(path, device=dev)
    tk = tokenizer_from_gguf(GGUFReader(path), native=True)
    ids = np.asarray(tk.encode(text), np.int32)
    X, Y = kv_quality.chunks(ids[len(ids) // 3:], KVQ_CHUNKS)
    steps = len(kv_quality.CACHES) * (X.shape[1] - 1)
    torch.cuda.synchronize()
    kernels.reset_launches()
    k0 = dict(captured.COUNTS)
    t1 = time.perf_counter()
    rows = kv_quality.run(cfg, params, X, Y)
    torch.cuda.synchronize()
    cap_ms = (time.perf_counter() - t1) * 1e3 / steps
    cap_counts = {k: captured.COUNTS[k] - k0[k] for k in k0}
    counts = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    with captured.disabled():
        eager = kv_quality.run(cfg, params, X, Y)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1e3 / steps
    form_err = {r[0]: abs(r[1] - e[1]) / e[1] for r, e in zip(rows, eager)}
    if max(form_err.values()) > KVQ_FORMS_RTOL or any(
            r[3] != e[3] for r, e in zip(rows, eager)) \
            or cap_counts["captures"] != len(kv_quality.CACHES):
        raise SystemExit(f"m2: the captured steps' rows {rows} vs the eager "
                         f"form's {eager} ({cap_counts})")
    want = cfg.n_layer * (X.shape[1] - 1) * 2  # two flat caches
    if counts["attn_decode"] != want:
        raise SystemExit(f"m2: attn_decode launches {counts['attn_decode']}"
                         f" != {want}")
    set_kernels(False)
    try:
        plain = kv_quality.run(cfg, params, X, Y,
                               caches=kv_quality.CACHES[1:])
    finally:
        set_kernels(None)
    errs = {r[0]: abs(r[1] - p[1]) / p[1] for r, p in zip(rows[1:], plain)}
    if max(errs.values()) > KVQ_PPL_RTOL:
        raise SystemExit(f"m2: decode ppl kernel vs plain route {errs}")
    out = {"card": smi, "chunks": int(X.shape[0]), "steps": X.shape[1] - 1,
           "head_dim": cfg.head_dim, "e_kv": cfg.n_head_kv * cfg.head_dim,
           "rows": [{"cache": n, "ppl": p, "dppl": d, "argmax_agree": a}
                    for n, p, d, a in rows],
           "plain_ppl": {n: p for n, p, _, _ in plain},
           "ppl_rel_err_vs_plain": errs,
           "eager_rows": [{"cache": n, "ppl": p, "argmax_agree": a}
                          for n, p, _, a in eager],
           "ppl_rel_err_captured_vs_eager": form_err,
           "step_ms": cap_ms, "eager_step_ms": eager_ms,
           "captured_counts": cap_counts,
           "seconds": time.perf_counter() - t0}
    emit({"kvq_m2": out})
    return out, counts


def load_example(repo, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(repo, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test2_objectives():
    """The reference's Test2 objectives (tests/test_optim.py:38-90): the
    least-squares and L1 line fits, a convex quadratic and Booth's
    function, each (fun of a (t0, t1) pair, start)."""
    import torch

    def xy(p):
        xi = torch.arange(1, 11, dtype=torch.float32, device=p[0].device)
        return xi, 10 * xi + 5

    def ls(p):
        x, y = xy(p)
        return torch.sum((p[0] + p[1] * x - y) ** 2) / 20

    def l1(p):
        x, y = xy(p)
        return 0.5 * torch.sum(torch.abs(p[0] + p[1] * x - y)) / 10

    return {"least_squares": (ls, (0.0, 0.0)), "l1": (l1, (-1.0, 9.0)),
            "quadratic": (lambda p: (5 * p[0] + p[1] - 35.0) ** 2
                          + (p[0] + 8 * p[1] - 42.0) ** 2, (1.0, 1.0)),
            "booth": (lambda p: (p[0] + 2 * p[1] - 7.0) ** 2
                      + (2 * p[0] + p[1] - 5.0) ** 2, (0.0, 0.0))}


def run_optax_compat_check(dev, n_iter=200):
    """optim.optax_compat on the card: opt_torch over GgmlAdam (alpha 0.01,
    Test2's setting, the default stopping rules, the first ``n_iter``
    iterations: thousands to convergence, each a host round trip) against
    opt_adam on each Test2 objective, both captured (one graph a call,
    replayed from the second iteration): the same losses at every
    iteration, the same iterations, result and final point (the same f32
    operations on the same card: bit for bit)."""
    import torch

    from ggmlsharp_tpu_torch.models import captured
    from ggmlsharp_tpu_torch.optim import (GgmlAdam, OptParams, opt_adam,
                                           opt_torch, value_and_grad)

    res = {}
    for name, (fun, start) in test2_objectives().items():
        p = OptParams()
        p.adam.alpha, p.adam.n_iter = 0.01, n_iter
        x0 = tuple(torch.tensor(v, device=dev) for v in start)
        vg = value_and_grad(fun)
        la, lt = [], []
        captured.reset_counts()
        xa, fa, ra, ia = opt_adam(vg, x0, p, lambda i, f: la.append(f))
        xt, ft, rt, it = opt_torch(vg, x0, lambda ps: GgmlAdam(ps, p.adam), p,
                                   lambda i, f: lt.append(f))
        same = la == lt and ia == it and ra == rt and all(
            torch.equal(a, b) for a, b in zip(xa, xt))
        res[name] = {"iters": it, "result": rt.name, "x": [float(v) for v in
                                                           xt],
                     "trajectory_equal": same,
                     "captures": captured.COUNTS["captures"],
                     "replays": captured.COUNTS["replays"]}
        if not same or res[name]["captures"] != 2:
            raise SystemExit(f"n: GgmlAdam vs opt_adam on {name}: {res}")
    return res


def run_profiler_check(dev, gen):
    """utils.OpProfiler over path h2's decoder graph (E 768, 12 heads, S 128,
    2 layers, flash_attn): every node's profiled value against
    Graph.compute's (the same op on the same inputs: 1e-6 relative, the
    card's matmuls may pick another algorithm between calls); the per-op
    rollup."""
    import torch

    from ggmlsharp_tpu_torch.graph import (build_forward, builders as B, leaf,
                                           set_data)
    from ggmlsharp_tpu_torch.utils import OpProfiler

    V, E, H, S = GRAPH_V, GRAPH_E, GRAPH_H, GRAPH_S
    shapes = [(V, E)] + ([(E, E)] * 4 + [(4 * E, E), (E, 4 * E)]) \
        * GRAPH_LAYERS
    weights = [torch.randn(s, generator=gen, device=dev) * 0.02
               for s in shapes]
    tok, logits, _ = graph_decoder(B, leaf, weights, S, H, plain=False)
    set_data(tok, torch.randint(0, V, (S,), generator=gen, device=dev,
                                dtype=torch.int32))
    graph = build_forward(logits)
    prof = OpProfiler(iters=3)
    prof.compute(graph)
    vals = {n.uid: n.data for n in graph.nodes if n.op != "none"}
    graph.compute()
    worst = max(float((vals[n.uid] - n.data).abs().max()
                      / n.data.abs().max().clamp_min(1e-30))
                for n in graph.nodes if n.op != "none")
    if worst > 1e-6:
        raise SystemExit(f"n: OpProfiler's values vs Graph.compute: {worst}")
    rollup = {k: round(v, 1) for k, v in sorted(
        prof.rollup().items(), key=lambda kv: -kv[1])}
    return {"nodes": len(prof.per_node), "rel_err_vs_compute": worst,
            "rollup_us": rollup, "perf_runs": graph.perf_runs}


def run_examples_n(smi, repo, dev, gen, workdir):
    """Path n: each example's entry in-process on the card, then the two
    modules. serve_torch (GPT-2 124M Q8_0) three times: plain, --int8-kv
    --prefix --stream, --draft, SERVE_EX_ARGS, every request its tokens;
    http_server_torch on port 0, one request, stop; quantize_model_torch's
    tiny random Llama to a GGUF and back, leaves bit for bit;
    train_graph_torch and graph_transformer_torch (main, then the
    graph's logits against the same graph on the CPU, 1e-4: f32 with TF32
    off); OpProfiler over path h2's decoder; GgmlAdam against opt_adam on
    Test2's objectives. Examples' printing goes to a buffer."""
    import io

    import torch

    from ggmlsharp_tpu_torch import GType, kernels
    from ggmlsharp_tpu_torch.io import load_gguf_llama
    from ggmlsharp_tpu_torch.models import llama

    t_all = time.perf_counter()
    out, buf = {"card": smi}, io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launches()
    serve = load_example(repo, "serve_torch")
    for tag, flags in (("plain", []),
                       ("int8_prefix_stream", ["--int8-kv", "--prefix",
                                               "--stream"]),
                       ("draft", ["--draft"])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eng, _, results, secs = serve.serve(serve.parse(SERVE_EX_ARGS
                                                            + flags))
        bad = [r.id for r in results
               if r.error is not None or len(r.out_tokens) != r.max_new_tokens]
        if len(results) != int(SERVE_EX_ARGS[1]) or bad:
            raise SystemExit(f"n: serve_torch {tag}: requests {bad} short")
        out[f"serve_{tag}"] = {
            "requests": len(results),
            "tokens": sum(len(r.out_tokens) for r in results),
            "seconds": secs, "wall_s": time.perf_counter() - t0,
            "stats": {k: eng.stats()[k] for k in ("ticks", "decode_forwards",
                                                  "prefill_dispatches")}}
        del eng
    http = load_example(repo, "http_server_torch")
    srv = http.start(http.parse(["--port", "0", "--slots", "2"]))
    try:
        ans = post_json(srv.port, {"prompt": [1, 2, 3], "max_new_tokens": 8})
    finally:
        srv.stop()
    if ans.get("error") is not None or len(ans["tokens"]) != 8:
        raise SystemExit(f"n: http_server_torch answered {ans}")
    out["http"] = {"tokens": ans["tokens"]}
    quant = load_example(repo, "quantize_model_torch")
    qpath = os.path.join(workdir, "tiny_q4_0.gguf")
    with contextlib.redirect_stdout(buf):
        quant.main(["--out", qpath, "--format", "q4_0"])
    qcfg, loaded = load_gguf_llama(qpath, device=dev)
    raw = llama.init_params(qcfg, torch.Generator(dev).manual_seed(0),
                            device=dev, dtype=torch.float32)
    want = llama.unfuse_params(llama.quantize_params(raw, GType.Q4_0), qcfg)
    diffs = bit_diffs(want, loaded)
    if diffs:
        raise SystemExit(f"n: quantize_model_torch round trip: {diffs[:5]}")
    out["quantize_model"] = {"bytes": os.path.getsize(qpath)}
    os.remove(qpath)
    tg = load_example(repo, "train_graph_torch")
    tbuf = io.StringIO()
    with contextlib.redirect_stdout(tbuf):
        tg.main([])
    num = r"(-?[\d.]+(?:e[-+]\d+)?)"
    fit = [float(v) for v in re.search(f"t0={num} t1={num}",
                                       tbuf.getvalue()).groups()]
    rb = re.search(rf"\({num}, {num}\) f={num} in (\d+) iters \((\w+)\)",
                   tbuf.getvalue()).groups()
    # Test2's bar on the fit (tests/test_optim.py:52), L-BFGS to (1, 1)
    if abs(fit[0] - 5) > 1e-3 or abs(fit[1] - 10) > 1e-3 or rb[4] != "OK" \
            or abs(float(rb[0]) - 1) > 1e-3 or abs(float(rb[1]) - 1) > 1e-3:
        raise SystemExit(f"n: train_graph_torch printed {tbuf.getvalue()}")
    out["train_graph"] = {"t0": fit[0], "t1": fit[1],
                          "rosenbrock": [float(rb[0]), float(rb[1])],
                          "f": float(rb[2]), "iters": int(rb[3]),
                          "result": rb[4]}
    gt = load_example(repo, "graph_transformer_torch")
    with contextlib.redirect_stdout(buf):
        gt.main([])
    lg = []
    for d in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(0)
        tok, graph, logits = gt.build_model(
            lambda s: torch.randn(s, generator=g) * 0.08, d)
        toks = gt.greedy(tok, graph, logits, [5, 17, 33], 8)
        lg.append((toks, logits.data.cpu()))
    gerr = float((lg[0][1] - lg[1][1]).abs().max())
    if gerr > 1e-4:
        raise SystemExit(f"n: graph_transformer_torch card vs CPU {gerr}")
    out["graph_transformer"] = {"tokens": lg[0][0],
                                "tokens_equal_cpu": lg[0][0] == lg[1][0],
                                "logits_max_abs_err_vs_cpu": gerr}
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    require_launches("n", counts, ("matmul_q8_0_mma", "flash_attn"))
    out["profiler"] = run_profiler_check(dev, gen)
    out["optax_compat"] = run_optax_compat_check(dev)
    out["seconds"] = time.perf_counter() - t_all
    emit({"examples_n": out})
    return out, counts


# --- the parallel layer (phase p): p0 a world of 1 on NCCL, p1 a world of 2
# on gloo (both ranks on cuda:0) at Llama-7B's full width, p2 a world of 4
# on gloo (data 2 x model 2) -------------------------------------------------

P_SLOTS, P_REQS, P_PLEN, P_NEW = 4, 8, 16, 16  # p1(a)'s engine
P_PP_B, P_PP_S, P_PP_MICRO = 4, 128, 2         # p1(b)'s forward_pp
P_RING_S = 256                                 # p1(c)'s prefill
P_OV_N, P_OV_K, P_OV_B = 4096, 11008, 2        # p1(d): w_down's shape
P_TOL = 0.1  # path a's bar under the path's settings (Q8_0 activations)
P_WO_TOL = 1e-3  # weight-only, f32 cache: f32 summation order alone
P_TINY_LLAMA = dict(n_vocab=256, n_ctx=128, n_embd=256, n_head=4,
                    n_head_kv=2, n_layer=2, n_ff=512)
P_TINY_GPT2 = dict(n_vocab=512, n_ctx=128, n_embd=256, n_head=4, n_layer=2)


def p_prompts(cfg, n, plen, seed=11):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.n_vocab, size=plen).tolist()
            for _ in range(n)]


def p_serve(cfg, params, prompts, n_new, slots, mesh=None, model=None,
            cache_dtype=None):
    """The engine over ``prompts`` (greedy, n_new tokens each): tokens by
    request, seconds, the engine's stats and its cache's KV heads."""
    import torch

    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.serving import Engine, Request

    model = model or llama
    eng = Engine(model.forward, cfg, params, batch_slots=slots, max_len=64,
                 cache_dtype=cache_dtype or torch.bfloat16, int8_kv=False,
                 mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit(Request(id=i, prompt=p, max_new_tokens=n_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    return ([r.out_tokens for r in res], time.perf_counter() - t0,
            eng.stats(), eng.cache.k[0].shape[1], eng.captured)


P0_REQS, P0_PLEN, P0_NEW, P0_SLOTS = 4, 16, 8, 4  # p0(b)'s 7B TP engine
P0_TIME_STEPS = 8  # p0(b): decode steps timed a form
P0_TRAIN_STEPS = 10  # p0(c): the training example's steps a form


def p_engine_form(cfg, params, prompts, n_new, slots, mesh, eager,
                  model=None):
    """One engine form over ``prompts`` (greedy): captured, or eager
    inside captured.disabled(). Its tokens, route, launches and
    captured.COUNTS over the run, then host ms a decode step (P0_TIME_STEPS
    steps at the run's bucket, no slot advancing, the card synchronized at
    the end) and device ms a step (a profiler window of one step: its
    post-processing takes seconds for an eager 7B step)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.models import captured, llama
    from ggmlsharp_tpu_torch.serving import Engine, Request

    model = model or llama
    with captured.disabled() if eager else contextlib.nullcontext():
        eng = Engine(model.forward, cfg, params, batch_slots=slots,
                     max_len=64, cache_dtype=torch.bfloat16, int8_kv=False,
                     mesh=mesh)
        for i, p in enumerate(prompts):
            eng.submit(Request(id=i, prompt=p, max_new_tokens=n_new))
        torch.cuda.synchronize()
        kernels.reset_launches()
        k0 = dict(captured.COUNTS)
        t0 = time.perf_counter()
        toks = [r.out_tokens for r in eng.run()]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = {"tokens": toks, "captured": eng.captured, "seconds": secs,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               **{k: captured.COUNTS[k] - k0[k] for k in k0}}
        tok = torch.zeros((slots, 1), dtype=torch.int32, device=eng.device)
        idle = torch.zeros(slots, dtype=torch.bool, device=eng.device)
        with torch.no_grad():
            rec["host_ms_per_step"] = p_time(
                lambda: eng._step(tok, idle, 64), P0_TIME_STEPS)
            prof = profile_steps(lambda: eng._step(tok, idle, 64), 1)
        rec["device_ms_per_step"] = prof["device_ms_per_step"]
    return rec


def p0_engines(res, mesh):
    """p0 (b): path a's Llama-7B Q4_0 (full width and depth, SEED) served
    tensor-parallel on the model = 1 mesh over NCCL, captured then eager,
    beside the single-device engine on the same requests; the tiny GPT-2
    Q8_0 TP engine (kernel 4 in a TP graph) in both forms."""
    import torch

    from ggmlsharp_tpu_torch.models import gpt2, llama
    from ggmlsharp_tpu_torch.parallel import (gpt2_param_specs,
                                              llama_param_specs, shard_params)

    cfg = llama.LLAMA_7B
    full = llama.synthetic_q4_0_params(cfg, seed=SEED, mlp_fused=False,
                                       layer_fused=False)
    sp = shard_params(full, llama_param_specs(), mesh)
    prompts = p_prompts(cfg, P0_REQS, P0_PLEN)
    forms = {f: p_engine_form(cfg, sp, prompts, P0_NEW, P0_SLOTS, mesh,
                              f == "eager") for f in ("captured", "eager")}
    single = p_engine_form(cfg, full, prompts, P0_NEW, P0_SLOTS, None, False)
    res["tp7b"] = {"prompts": prompts, **forms, "single": single}
    del sp, full
    torch.cuda.empty_cache()
    gcfg = gpt2.GPT2Config(**P_TINY_GPT2)
    sg = shard_params(gpt2.synthetic_q8_0_params(gcfg, seed=1),
                      gpt2_param_specs(), mesh)
    res["tp_gpt2"] = {f: p_engine_form(gcfg, sg, p_prompts(gcfg, 4, 8), 6,
                                       2, mesh, f == "eager", model=gpt2)
                      for f in ("captured", "eager")}


def p0_train(res, repo, wd, dev):
    """p0 (c): examples/train_distributed_torch.py's train() on the world
    of one over NCCL: P0_TRAIN_STEPS steps captured, then eager
    (captured.disabled()) from the same seed, each checkpointing; then
    each resumed from its own checkpoint for 5 more, in its form."""
    from ggmlsharp_tpu_torch.models import captured

    ex = load_example(repo, "train_distributed_torch")
    out = {}
    for form in ("captured", "eager"):
        ck_dir = os.path.join(wd, f"p0_train_{form}")
        with captured.disabled() if form == "eager" \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            first = ex.train(ex.parse(["--steps", str(P0_TRAIN_STEPS),
                                       "--ckpt", ck_dir]), dev)
            secs = time.perf_counter() - t0
            resumed = ex.train(ex.parse(["--steps", "5", "--ckpt", ck_dir]),
                               dev)
        out[form] = {"losses": first["losses"], "captured": first["captured"],
                     "seconds": secs, "resumed_at": resumed["resumed_at"],
                     "resumed_losses": resumed["losses"],
                     "resumed_captured": resumed["captured"]}
    res["train"] = out


def p_time(fn, n):
    """Host ms a call of fn over n calls, the card synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def p_part(name, fn, steps, prof_step=None, n_prof=2):
    """Run a part of p1 once, the ranks met at a barrier and the launch
    counters and gloo's staged bytes reset just before: its result, and the
    part's launches, host ms a step, staged bytes; then the device ms a
    step from a torch.profiler window of prof_step (every rank profiles at
    once)."""
    import torch

    from ggmlsharp_tpu_torch import kernels
    from ggmlsharp_tpu_torch.parallel import comm

    torch.cuda.synchronize()
    torch.distributed.barrier()  # no rank's wait for another is timed
    comm.reset_staged()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    rec = {"launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
           "host_ms_per_step": host_ms, "steps": steps,
           "staged_bytes": comm.STAGED["bytes"]}
    if prof_step is not None:
        with torch.no_grad():
            prof = profile_steps(prof_step, n_prof)
        rec["device_ms_per_step"] = prof["device_ms_per_step"]
        rec["traced_step_ms"] = prof["traced_step_ms"]
    return out, rec


def p_rows_err(y, y0, w, x):
    """max |y - y0| over sum_k |x_k| |w_nk| (the b = 1 vs multi-row bar,
    ROADMAP §3: at most 1e-5)."""
    from ggmlsharp_tpu_torch.quant.quantize import dequantize

    scale = x.abs() @ dequantize(w).abs().T
    return float(((y - y0).abs() / scale).max())


def p_env(name, value):
    @contextlib.contextmanager
    def ctx():
        old = os.environ.get(name)
        os.environ[name] = value
        try:
            yield
        finally:
            os.environ.pop(name, None)
            if old is not None:
                os.environ[name] = old
    return ctx()


def p_tree_equal(a, b):
    """Leaves of two trees bit for bit (QTensor planes, tensors, None)."""
    import torch

    from ggmlsharp_tpu_torch.quant.formats import QTensor

    if isinstance(a, dict):
        keys = set(a) - {"tp"}
        return keys == set(b) - {"tp"} and all(p_tree_equal(a[k], b[k])
                                               for k in keys)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(p_tree_equal, a, b))
    if a is None or b is None:
        return a is b
    if isinstance(a, QTensor):
        return isinstance(b, QTensor) and a.shape == b.shape and all(
            torch.equal(a.planes[k], b.planes[k]) for k in a.planes)
    return a.dtype == b.dtype and torch.equal(a, b)


def p_save(wd, name, rank, obj):
    import torch

    torch.save(obj, os.path.join(wd, f"{name}_{rank}.pt"))


def _p0_rank(rank, wd, repo):
    """p0: a world of one on NCCL. Tiny Llama Q4_0 and GPT-2 Q8_0 through
    every entry point, each against the unsharded port: bit for bit where
    the route is the same function (one rank's sum is an identity); then
    (b) the captured TP engines (p0_engines) and (c) the training example
    captured and eager (p0_train)."""
    import shutil

    import torch

    from ggmlsharp_tpu_torch import kernels, ops
    from ggmlsharp_tpu_torch.io import checkpoint as ck
    from ggmlsharp_tpu_torch.models import gpt2, llama
    from ggmlsharp_tpu_torch.models.llama import random_q4_0
    from ggmlsharp_tpu_torch.parallel import (gpt2_param_specs, kv_cache_spec,
                                              llama_param_specs, make_mesh,
                                              set_sequence_mesh, shard_cache,
                                              shard_params)
    from ggmlsharp_tpu_torch.parallel.mesh import make_axis_mesh
    from ggmlsharp_tpu_torch.parallel.overlap import \
        row_parallel_mul_mat_overlapped

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.reset_launches()
    res = {"backend": torch.distributed.get_backend()}
    mesh = make_mesh(model=1)
    cfg = llama.LlamaConfig(**P_TINY_LLAMA)
    params = llama.synthetic_q4_0_params(cfg, seed=1, mlp_fused=False,
                                         layer_fused=False)
    sp = shard_params(params, llama_param_specs(), mesh)
    gen = torch.Generator(dev).manual_seed(2)
    toks = torch.randint(0, cfg.n_vocab, (2, 16), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32, device=dev)[None].expand(2, 16)
    with torch.no_grad():
        want, _ = llama.forward(params, cfg, toks, llama.new_cache(cfg, 2),
                                pos)
        got, _ = llama.forward(sp, cfg, toks, shard_cache(
            llama.new_cache(cfg, 2), kv_cache_spec(), mesh), pos)
    res["llama_forward_bit_equal"] = bool(torch.equal(got, want))
    prompts = p_prompts(cfg, 4, 8)
    a = p_serve(cfg, params, prompts, 6, 2)[0]
    b = p_serve(cfg, sp, prompts, 6, 2, mesh=mesh)[0]
    res["llama_engine_tokens_equal"] = a == b
    pipe = make_axis_mesh("pipe", 1)
    with torch.no_grad():
        # one microbatch: the stage's calls have the sequential loop's shapes
        got = llama.forward_pp(params, cfg, toks, pipe, n_micro=1)
        x = ops.get_rows(params["tok_embd"], toks).to(params["norm"].dtype)
        for blk in params["blocks"]:
            x = llama._apply_block(blk, x, cfg).to(torch.float32)
        x = llama._rms(x, params["norm"], cfg.rms_eps)
        want = ops.mul_mat(params["output"], x.to(torch.float32),
                           quantize_acts=False)[..., :cfg.n_vocab]
    res["forward_pp_bit_equal"] = bool(torch.equal(got, want))
    seq = make_axis_mesh("seq", 1)
    with p_env("GGML_TPU_QUANT_ACTS", "0"), torch.no_grad():
        with p_env("GGML_TPU_ATTN", "legacy"):
            want, _ = llama.forward(params, cfg, toks, llama.new_cache(
                cfg, 2, dtype=torch.float32), pos)
        set_sequence_mesh(seq, "seq")
        try:
            with p_env("GGML_TPU_ATTN", "ring"):
                got, _ = llama.forward(params, cfg, toks, llama.new_cache(
                    cfg, 2, dtype=torch.float32), pos)
        finally:
            set_sequence_mesh(None)
    res["ring_vs_legacy_max_abs_err"] = float((got - want).abs().max())
    w = random_q4_0(256, 1024, gen, dev)
    xo = torch.randn((2, 1024), generator=gen, device=dev)
    res["overlap_bit_equal"] = bool(torch.equal(
        row_parallel_mul_mat_overlapped(w, xo, mesh),
        ops.mul_mat(w, xo, quantize_acts=False)))
    path = os.path.join(wd, "p0_ck")
    ck.save_checkpoint_sharded(path, sp, step=3)
    like, step = ck.load_checkpoint_sharded(path, like=sp)
    whole, _ = ck.load_checkpoint_sharded(path)
    res["checkpoint_bit_equal"] = (step == 3 and p_tree_equal(like, sp)
                                   and p_tree_equal(whole, params))
    shutil.rmtree(path, ignore_errors=True)
    gcfg = gpt2.GPT2Config(**P_TINY_GPT2)
    gp = gpt2.synthetic_q8_0_params(gcfg, seed=1)
    sg = shard_params(gp, gpt2_param_specs(), mesh)
    gt = toks % gcfg.n_vocab
    with torch.no_grad():
        want, _ = gpt2.forward(gp, gcfg, gt, gpt2.new_cache(gcfg, 2), pos)
        got, _ = gpt2.forward(sg, gcfg, gt, shard_cache(
            gpt2.new_cache(gcfg, 2), kv_cache_spec(), mesh), pos)
    # the sharded route takes the matmul pair where the whole model takes
    # the fused GELU MLP kernel: path c's bar
    res["gpt2_forward_max_abs_err"] = float((got - want).abs().max())
    res["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    p0_engines(res, mesh)
    p0_train(res, repo, wd, dev)
    p_save(wd, "p0", rank, res)


def _p1_rank(rank, wd):
    """p1: a world of 2 on gloo, both ranks on cuda:0, Llama-7B Q4_0 at full
    width and depth (synthetic_q4_0_params, seed 0, path a's weights):
    (a) TP serving, (b) forward_pp, (c) the ring prefill, (d) the
    overlapped matmul at w_down's shape."""
    import torch

    from ggmlsharp_tpu_torch import ops
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.models.llama import random_q4_0
    from ggmlsharp_tpu_torch.parallel import (kv_cache_spec,
                                              llama_param_specs, make_mesh,
                                              set_sequence_mesh, shard_cache,
                                              shard_params)
    from ggmlsharp_tpu_torch.parallel.mesh import make_axis_mesh
    from ggmlsharp_tpu_torch.parallel.overlap import \
        row_parallel_mul_mat_overlapped

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    marks = {}  # seconds from the rank's start to the end of each stage
    cfg = llama.LLAMA_7B
    full = llama.synthetic_q4_0_params(cfg, seed=SEED, mlp_fused=False,
                                       layer_fused=False)
    mesh = make_mesh(model=2)
    res = {"backend": torch.distributed.get_backend(), "marks": marks}
    marks["params"] = time.perf_counter() - t0

    # (a) TP serving: P_REQS requests of P_PLEN + P_NEW greedy tokens
    sp = shard_params(full, llama_param_specs(), mesh)
    torch.cuda.synchronize()
    marks["sharded"] = time.perf_counter() - t0
    (toks, secs, st, heads, route), rec = p_part(
        "a", lambda: p_serve(cfg, sp, p_prompts(cfg, P_REQS, P_PLEN), P_NEW,
                             P_SLOTS, mesh=mesh), 1)
    marks["a_served"] = time.perf_counter() - t0
    cache = shard_cache(llama.new_cache(cfg, P_SLOTS, max_len=64),
                        kv_cache_spec(), mesh)
    tok = torch.zeros((P_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.full((P_SLOTS, 1), 20, dtype=torch.int32, device=dev)
    prof = profile_steps(lambda: llama.forward(sp, cfg, tok, cache, pos,
                                               prefix_bound=64), 2)
    steps = st["decode_forwards"] + st["prefill_dispatches"]
    rec.update(captured=route,
               host_ms_per_step=rec["host_ms_per_step"] / steps, steps=steps, seconds=secs, tokens_per_s=sum(map(len, toks))
               / secs, device_ms_per_decode_step=prof["device_ms_per_step"],
               decode_step_traced_ms=prof["traced_step_ms"],
               cache_heads=heads, tokens=toks, stats=st)
    res["a"] = rec
    del sp, cache
    marks["a"] = time.perf_counter() - t0

    # (b) forward_pp: 2 stages of 16 blocks, B 4, S 128, 2 microbatches,
    # against the single-device fresh-cache forward (rank 0)
    pipe = make_axis_mesh("pipe", 2)
    g = torch.Generator(dev).manual_seed(21)
    ptoks = torch.randint(0, cfg.n_vocab, (P_PP_B, P_PP_S), generator=g,
                          device=dev, dtype=torch.int32)
    ppos = torch.arange(P_PP_S, dtype=torch.int32,
                        device=dev)[None].expand(P_PP_B, P_PP_S)
    own = dict(full, blocks=[b if i // (cfg.n_layer // 2) == rank else None
                             for i, b in enumerate(full["blocks"])])
    errs = {}
    # weight-only in mm_dot "f32" (compare_plain's rule): the f32 function
    for acts, tol, mode in (("1", P_TOL, "bf16"), ("0", P_WO_TOL, "f32")):
        with p_env("GGML_TPU_QUANT_ACTS", acts), mm_dot(mode), \
                torch.no_grad():
            lg, rec = p_part("b", lambda: llama.forward_pp(
                own, cfg, ptoks, pipe, n_micro=P_PP_MICRO), 1,
                prof_step=(lambda: llama.forward_pp(
                    own, cfg, ptoks, pipe, n_micro=P_PP_MICRO))
                if acts == "1" else None, n_prof=1)
            if rank == 0:
                want, _ = llama.forward(full, cfg, ptoks, llama.new_cache(
                    cfg, P_PP_B, dtype=torch.float32, max_len=P_PP_S), ppos)
                errs[acts] = float((lg - want).abs().max())
                if not errs[acts] <= tol:
                    raise SystemExit(f"p1 (b): forward_pp vs the single-device "
                                     f"forward {errs[acts]} > {tol} "
                                     f"(activations {acts})")
        if acts == "1":
            res["b"] = rec
    res["b"]["max_abs_err"] = errs
    marks["b"] = time.perf_counter() - t0

    # (c) a P_RING_S-token prefill under GGML_TPU_ATTN=ring over a 2-rank
    # sequence mesh, against the legacy route (rank 0), f32 caches
    seq = make_axis_mesh("seq", 2)
    rtoks = torch.randint(0, cfg.n_vocab, (1, P_RING_S), generator=g,
                          device=dev, dtype=torch.int32)
    rpos = torch.arange(P_RING_S, dtype=torch.int32, device=dev)[None]

    def prefill():
        return llama.forward(full, cfg, rtoks, llama.new_cache(
            cfg, 1, dtype=torch.float32, max_len=P_RING_S), rpos)[0]

    errs = {}
    for acts, tol, mode in (("1", P_TOL, "bf16"), ("0", P_WO_TOL, "f32")):
        with p_env("GGML_TPU_QUANT_ACTS", acts), mm_dot(mode), \
                torch.no_grad():
            set_sequence_mesh(seq, "seq")
            try:
                with p_env("GGML_TPU_ATTN", "ring"):
                    lg, rec = p_part("c", prefill, 1, n_prof=1,
                                     prof_step=prefill if acts == "1"
                                     else None)
            finally:
                set_sequence_mesh(None)
            if rank == 0:
                with p_env("GGML_TPU_ATTN", "legacy"):
                    want = prefill()
                errs[acts] = float((lg - want).abs().max())
                if not errs[acts] <= tol:
                    raise SystemExit(f"p1 (c): ring vs legacy {errs[acts]} > "
                                     f"{tol} (activations {acts})")
        if acts == "1":
            res["c"] = rec
    res["c"]["max_abs_err"] = errs
    del full, own
    marks["c"] = time.perf_counter() - t0

    # (d) the overlapped row-parallel matmul at w_down's shape against
    # mul_mat on one device
    w = random_q4_0(P_OV_N, P_OV_K, g, dev)
    x = torch.randn((P_OV_B, P_OV_K), generator=g, device=dev)

    def ov():
        return row_parallel_mul_mat_overlapped(w, x, mesh)

    with torch.no_grad():
        y, rec = p_part("d", ov, 1, prof_step=ov, n_prof=3)
        rec["host_ms_per_step_warm"] = p_time(ov, 5)
        y0 = ops.mul_mat(w, x, quantize_acts=False)
    rec["rows_err_over_sum"] = p_rows_err(y, y0, w, x)
    if not rec["rows_err_over_sum"] <= 1e-5:
        raise SystemExit(f"p1 (d): overlapped matmul {rec}")
    res["d"] = rec
    marks["d"] = time.perf_counter() - t0
    p_save(wd, "p1", rank, res)


def _p1_reference(cfg, params):
    """p1(a)'s reference: the single-device engine's tokens (kernels) over
    the requests the ranks serve."""
    prompts = p_prompts(cfg, P_REQS, P_PLEN)
    toks, secs, st, _, _ = p_serve(cfg, params, prompts, P_NEW, P_SLOTS)
    return prompts, toks, secs


def _p2_resume_rank(rank, wd, repo, argv):
    """p2's restart: a new world of four, started while the first run
    trains (its start-up hidden behind it), that waits for the first run
    to end and then resumes the example from its newest sharded
    checkpoint (the example's train(), as its main runs it on each
    rank)."""
    import torch

    marker = os.path.join(wd, "p2_first_done")
    deadline = time.monotonic() + 900
    while not os.path.exists(marker):
        if time.monotonic() > deadline:
            raise SystemExit("p2: the first run did not end")
        time.sleep(0.05)
    with open(marker) as f:
        status = f.read()
    if status != "ok":
        raise SystemExit(f"p2: the first run failed ({status}); no resume")
    ex = load_example(repo, "train_distributed_torch")
    if ex.train(ex.parse(argv), torch.device("cuda", 0))["captured"]:
        raise SystemExit("p2: a step over gloo was captured")


def p0_checks(smi, p0, cfg, params):
    """p0 (b) and (c) held: the captured 7B TP engine's tokens and launches
    equal its eager twin's, and its tokens the single-device engine's on
    every decided position (plain top-2 gap above 2 * P_TOL); the GPT-2 TP
    engine likewise, kernel 4 in its graphs; the training example's losses
    bit-equal in both forms, and each resumed at its checkpoint."""
    import torch

    from ggmlsharp_tpu_torch.models import llama

    tp = p0["tp7b"]
    c, e, sd = tp["captured"], tp["eager"], tp["single"]
    if not (c["captured"] and c["tokens"] == e["tokens"]
            and c["launches"] == e["launches"] and c["captures"] > 0
            and c["replays"] > 0 and e["captures"] == 0
            and all(len(t) == P0_NEW for t in c["tokens"])):
        raise SystemExit(f"p0 (b): the captured TP engine differs from its "
                         f"eager twin: {tp}")
    partings = {}
    dev = torch.device("cuda")
    for i, (g, w, pr) in enumerate(zip(c["tokens"], sd["tokens"],
                                       tp["prompts"])):
        if g == w:
            continue
        gp = plain_gaps(llama, cfg, params,
                        torch.tensor([pr], dtype=torch.int32, device=dev),
                        torch.tensor([w], dtype=torch.int32,
                                     device=dev)).tolist()
        j, decided = held_to_reference(g, w, gp, P_TOL)
        if decided:
            raise SystemExit(f"p0 (b): request {i} parts from the "
                             f"single-device engine at {j} (decided)")
        partings[i] = {"at": j, "plain_gap": gp[j]}
    g2 = p0["tp_gpt2"]
    gc, ge = g2["captured"], g2["eager"]
    if not (gc["captured"] and gc["tokens"] == ge["tokens"]
            and gc["launches"] == ge["launches"] and gc["captures"] > 0
            and (gc["launches"].get("matmul_q8_0", 0)
                 + gc["launches"].get("matmul_q8_0_mma", 0)) > 0):
        raise SystemExit(f"p0 (b): the captured GPT-2 TP engine: {g2}")
    tr = p0["train"]
    tc, te = tr["captured"], tr["eager"]
    if not (tc["captured"] and tc["resumed_captured"]
            and tc["losses"] == te["losses"]
            and tc["resumed_losses"] == te["resumed_losses"]
            and tc["resumed_at"] == te["resumed_at"] == P0_TRAIN_STEPS
            and len(tc["losses"]) == P0_TRAIN_STEPS
            and all(x == x and abs(x) < 1e30 for x in tc["losses"]
                    + tc["resumed_losses"])):
        raise SystemExit(f"p0 (c): the training example's forms: {tr}")
    rec = {"card": smi, "tp7b": {f: {k: v for k, v in tp[f].items()
                                     if k != "tokens"}
                                 for f in ("captured", "eager", "single")},
           "tp7b_partings_from_single_device": partings,
           "tp_gpt2": {f: {k: v for k, v in g2[f].items() if k != "tokens"}
                       for f in ("captured", "eager")},
           "train": tr}
    emit({"parallel_p0_captured": rec})
    log(f"[4/6] p0 (b) Llama-7B Q4_0 TP engine on NCCL (model 1), "
        f"{P0_REQS} x {P0_PLEN}+{P0_NEW}, captured [eager]: tokens and "
        f"launches equal, {c['captures']} captures, {c['replays']} replays "
        f"[{e['replays']}], decode step host {c['host_ms_per_step']:.2f} "
        f"[{e['host_ms_per_step']:.2f}] ms, device "
        f"{c['device_ms_per_step']} [{e['device_ms_per_step']}] ms; the "
        f"single-device engine {sd['host_ms_per_step']:.2f} ms host, "
        f"partings {partings}; GPT-2 Q8_0 TP engine captured = eager, "
        f"launches {gc['launches']}; (c) train_distributed_torch "
        f"{P0_TRAIN_STEPS} steps captured = eager bit for bit (losses "
        f"{tc['losses'][0]:.4f} -> {tc['losses'][-1]:.4f}, "
        f"{tc['seconds']:.2f} [{te['seconds']:.2f}] s), resumed at "
        f"{tc['resumed_at']} for 5, equal ({smi})")
    return rec


def run_parallel_phase(smi, repo, cfg, params):
    """Phase p: p1, then p2 with p0 beside it, the ranks spawned with
    torch.multiprocessing (the kernels built in this process first). A
    failed rank, or a collective past the process group's timeout, fails
    the script. What overlaps reports no rate: p1's single-device
    reference runs here while p1's ranks start; p0 (checks only) runs
    once the dry run has ended, beside the example's first run, as the
    restart's ranks start."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.parallel import dryrun
    from ggmlsharp_tpu_torch.parallel.distributed import spawn

    def timed(fn, *a, **kw):
        t = time.perf_counter()
        fn(*a, **kw)
        return time.perf_counter() - t

    t_all = time.perf_counter()
    wd = tempfile.mkdtemp(prefix="chip_smoke_p_")
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(
                timed, spawn, _p1_rank, 2, args=(wd,), backend="gloo",
                device="cuda:0", init_file=os.path.join(wd, "p1_store"),
                timeout_s=600)
            prompts, want, ref_secs = _p1_reference(cfg, params)
            ranks_secs = ranks.result()
        p1 = [torch.load(os.path.join(wd, f"p1_{r}.pt"), weights_only=False)
              for r in range(2)]
        got = [r["a"]["tokens"] for r in p1]
        if got[0] != got[1]:
            raise SystemExit(f"p1 (a): the ranks' tokens differ: {got}")
        partings = {}
        dev = torch.device("cuda")
        for i, (g, w, pr) in enumerate(zip(got[0], want, prompts)):
            if len(g) != P_NEW:
                raise SystemExit(f"p1 (a): request {i} gave {g}")
            if g == w:
                continue
            # the plain route's top-2 gaps along the reference's tokens
            gp = plain_gaps(llama, cfg, params,
                            torch.tensor([pr], dtype=torch.int32, device=dev),
                            torch.tensor([w], dtype=torch.int32,
                                         device=dev)).tolist()
            j, decided = held_to_reference(g, w, gp, P_TOL)
            if decided:
                raise SystemExit(f"p1 (a): request {i} parts from the "
                                 f"single-device engine at {j} (decided)")
            partings[i] = {"at": j, "plain_gap": gp[j]}
        for r in p1:
            if r["backend"] != "gloo" or r["a"]["captured"] or \
                    not r["a"]["launches"].get(
                    "matmul_q4_0_mma") or not r["a"]["launches"].get(
                    "flash_attn"):
                raise SystemExit(f"p1: launches {r}")
        secs = time.perf_counter() - t0
        summary = {"card": smi, "seconds": secs, "ranks_seconds": ranks_secs,
                   "reference_engine_seconds": ref_secs,
                   "tokens_equal_across_ranks": True,
                   "partings_from_single_device": partings,
                   "tokens_equal_single_device": sum(
                       a == b for g, w in zip(got[0], want)
                       for a, b in zip(g, w)),
                   "tokens": P_REQS * P_NEW,
                   "rank_marks_s": [r["marks"] for r in p1],
                   "ranks": [{k: {kk: vv for kk, vv in r[k].items()
                                  if kk not in ("tokens", "stats")}
                              for k in "abcd"} for r in p1]}
        emit({"parallel_p1": summary})
        for part in "abcd":
            log(f"[4/6] p1 ({part}) " + "; ".join(
                f"rank {i}: launches {r[part]['launches']}, host "
                f"{r[part]['host_ms_per_step']:.2f} ms a step, device "
                f"{r[part].get('device_ms_per_step', r[part].get('device_ms_per_decode_step'))}"
                f" ms a step, gloo staged {r[part]['staged_bytes']} B"
                for i, r in enumerate(p1)) + f" ({smi})")
        log(f"[4/6] p1. world of 2 on gloo (cuda:0) in {secs:.1f} s (the "
            f"ranks {ranks_secs:.1f} s, rank 0's stages end at "
            f"{ {k: round(v, 1) for k, v in p1[0]['marks'].items()} } s): TP "
            f"serving {P_REQS} x {P_PLEN}+{P_NEW} tokens equal on both ranks, "
            f"{summary['tokens_equal_single_device']}/{P_REQS * P_NEW} equal "
            f"to the single-device engine (partings {partings}); forward_pp "
            f"err {p1[0]['b']['max_abs_err']}; ring err "
            f"{p1[0]['c']['max_abs_err']}; overlap rows err over sum "
            f"{p1[0]['d']['rows_err_over_sum']:.3g}")

        ex = load_example(repo, "train_distributed_torch")
        ckd = os.path.join(wd, "train_ck")
        argv = ["--world", "4", "--data", "2", "--ckpt", ckd]
        marker = os.path.join(wd, "p2_first_done")

        def first_run():
            status = "failed"
            try:
                ex.main(argv + ["--steps", "20"])
                status = "ok"
            finally:  # the restart's ranks wait for this either way
                with open(marker, "w") as f:
                    f.write(status)

        def p0_world():
            spawn(_p0_rank, 1, args=(wd, repo), backend="nccl",
                  device="cuda:0",
                  init_file=os.path.join(wd, "p0_store"), timeout_s=600)

        # the dry run's world and the example's beside it (two worlds of
        # four ranks on the card at once); once the dry run ends, p0 and
        # the restart's world start, the restart waiting for the first run
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            first = pool.submit(timed, first_run)
            t_dry = pool.submit(timed, dryrun.run, 4).result()
            resumed = pool.submit(
                timed, spawn, _p2_resume_rank, 4,
                args=(wd, repo, argv + ["--steps", "5"]), backend="gloo",
                device="cuda:0", init_file=os.path.join(wd, "p2r_store"))
            t_p0 = timed(p0_world)
            t_ex = first.result()
            t_res = resumed.result()
        p0 = torch.load(os.path.join(wd, "p0_0.pt"), weights_only=False)
        p0["seconds"] = t_p0
        emit({"parallel_p0": p0})
        bad = [k for k in ("llama_forward_bit_equal",
                           "llama_engine_tokens_equal",
                           "forward_pp_bit_equal", "overlap_bit_equal",
                           "checkpoint_bit_equal") if not p0[k]]
        if bad or p0["backend"] != "nccl" \
                or not p0["ring_vs_legacy_max_abs_err"] <= P_WO_TOL \
                or not p0["gpt2_forward_max_abs_err"] <= P_TOL:
            raise SystemExit(f"p0: {bad or p0}")
        log(f"[4/6] p0. world of 1 on NCCL in {t_p0:.1f} s: TP "
            f"forward, TP engine, forward_pp, overlap and the sharded "
            f"checkpoint bit-equal to the unsharded port; ring vs legacy "
            f"{p0['ring_vs_legacy_max_abs_err']:.3g}; GPT-2 TP route vs "
            f"whole {p0['gpt2_forward_max_abs_err']:.3g}; launches "
            f"{p0['launches']}")
        p0_checks(smi, p0, cfg, params)
        ck_dirs = sorted(os.listdir(ckd))
        if ck_dirs != ["step_00000010", "step_00000020", "step_00000025"]:
            raise SystemExit(f"p2: checkpoints {ck_dirs}")
        p2 = {"dryrun_seconds": t_dry, "example_seconds": t_ex,
              "resume_world_seconds": t_res,
              "seconds": time.perf_counter() - t0, "checkpoints": ck_dirs}
        emit({"parallel_p2": p2})
        log(f"[4/6] p2. worlds of 4 on gloo (data 2 x model 2): "
            f"dryrun.run(4) in {t_dry:.1f} s beside "
            f"train_distributed_torch --steps 20 in {t_ex:.1f} s, then "
            f"resumed from its sharded checkpoint for 5 by a new world "
            f"({t_res:.1f} s from its spawn, p0's beside it); p2 "
            f"{p2['seconds']:.1f} s: {ck_dirs}; phase p "
            f"{time.perf_counter() - t_all:.1f} s")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    counts = dict.fromkeys(__import__(
        "ggmlsharp_tpu_torch.kernels", fromlist=["LAUNCHES"]).LAUNCHES, 0)
    for part in "abcd":
        for k, v in p1[0][part]["launches"].items():
            counts[k] += v
    for k, v in p0["launches"].items():
        counts[k] += v
    return {"p0": p0, "p1": summary, "p2": p2}, counts


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    timing_only = argv[:1] in (["--attention-timing"], ["--matmul-timing"])
    if timing_only and len(argv) > 1:
        repo = os.path.abspath(argv[1])
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
    if timing_only:
        log(f"card: {smi} | package {repo}")
        (attention_timing if argv[0] == "--attention-timing"
         else matmul_timing)(torch.device("cuda"))
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    log(f"[1/6] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from ggmlsharp_tpu_torch.kernels.config import kernels_setting
    from ggmlsharp_tpu_torch.probes import q8_acts
    from ggmlsharp_tpu_torch.probes.dq_variants import variant_defines

    if kernels_setting() is not None:
        raise SystemExit(f"kernels_enabled() must be auto on every path, is "
                         f"forced to {kernels_setting()}")
    t0 = time.perf_counter()
    # every source, and the probe builds of matmul_q4_0.cu and
    # matmul_q8_0.cu, in parallel
    logs = kernels.build(variants=[("matmul_q4_0", variant_defines(v))
                                   for v in ("i2f", "half2")]
                         + [(q8_acts.ENTRY, q8_acts.variant_defines("bf16")),
                            ("llama_layer", LAYER_NO_MATVEC),
                            ("gpt2_layer", LAYER_NO_MATVEC),
                            # a3's if-chain parent
                            ("graph_switch", ("GS_SWITCH=0",))])
    log(f"[2/6] built {sorted(logs) or 'nothing new'} in "
        f"{time.perf_counter() - t0:.1f} s")
    if argv[:1] == ["--parallel"]:  # phase p alone (development mode)
        cfg = llama.LLAMA_7B
        params = llama.synthetic_q4_0_params(cfg, seed=SEED, mlp_fused=False,
                                             layer_fused=False)
        run_parallel_phase(smi, repo, cfg, params)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
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
    repeats = check_one_row_repeats(dev, gen)
    llayer_err = check_llama_layer(dev, gen)
    attn_lay_err = check_attn_layout(dev, gen)
    ragged_err = check_ragged(dev, gen)
    mq_errs = check_matmul_q(dev, gen)
    ib_errs = check_int_dot(dev, gen)
    q_card = quantizers_on_card(dev, gen)
    geom_cases = check_geometries(dev, gen)
    chain_mm_err = check_chain_matmuls(dev, gen)
    gs_err, gs_row = check_graph_switch(dev, gen)
    if not q4_rows_ok:
        raise SystemExit("a Q4_0 row's result depends on b")
    log(f"[3/6] kernels agree with their plain versions: Q4_0 max abs err "
        f"{q4_err:.3g} at b {CHECK_B} (a row's bits equal at b {MMA_B}: "
        f"{q4_rows_ok}), flash "
        f"{fl_err:.3g}, attn_decode {ad_err:.3g} (attn lane map "
        f"{attn_lay_err:.3g}), Q8_0 {q8_err:.3g} at b {Q8_CHECK_B} (a "
        f"row's bits equal at b >= 2), mlp_fused_q8 {mlp_err:.3g}, gpt2_layer "
        f"{layer_err:.3g}, mlp_fused_silu_q4 {silu_err:.3g} at rows "
        f"{SILU_CHECK_ROWS} and E, F {SILU_SHORT}, {SILU_13B} (one row); "
        f"kernels 8, 11, 9 back to back and in a graph replay, {repeats} "
        f"launches bit-equal to their first; llama_layer "
        f"{llayer_err:.3g}; matmul_q {max(mq_errs.values()):.3g} (7 "
        f"formats, b as Q4_0's, rows as Q4_0's), matmul_int_dot "
        f"{max(ib_errs.values()):.3g} (5 formats); flash entries "
        f"{ {k: float(f'{v:.3g}') for k, v in fl2_err.items()} } (uncached, "
        f"softcap, f16, D 8-256, gradients, HVP); kernels 2 and 3 at ragged "
        f"edges {ragged_err:.3g}; quantizers on the card "
        f"vs the CPU, share of blocks differing: "
        f"{max(q_card.values()):.3g}; launch geometries bit-equal to the "
        f"default in {geom_cases} cases; path m1's w_down (192 x 512, 127 "
        f"and 128 rows, Q4_0 Q4_K Q6_K Q8_0) {chain_mm_err:.3g}; the bucket "
        f"switch's selector ({gs_row['design']}) vs its plain version "
        f"{gs_err} in {gs_row['cases']} cases; rms rows "
        f"differing alone "
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
    # phase 4's greedy generate calls, each beside its eager twin (through
    # path l)
    twins = contextlib.ExitStack()
    twins.enter_context(eager_twins())
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
        f"greedy tokens through the kernels, captured; launches {counts}; "
        f"eager twin equal: {TWINS[0]}")
    cap_checks = captured_checks(dev)
    log(f"[4/6] a host sync in a captured step raised "
        f"({cap_checks['host_sync'][:70]!r}); a sync buffer made in a "
        f"capture raised; the card works after both")
    gc_res = graph_cache_phase(smi, cfg, params, prompt, toks)
    gc_calls = gc_res["calls"]
    log(f"[4/6] a2. graph cache, path a: {GRAPH_CACHE_CALLS} generate calls "
        f"with fresh caches from an empty cache: captures "
        f"{[c['captures'] for c in gc_calls]} (capture s "
        f"{[round(c['capture_s'], 3) for c in gc_calls]}, of it warm-up "
        f"{[round(c['warmup_s'], 3) for c in gc_calls]}), host s a call "
        f"{[round(c['host_s'], 3) for c in gc_calls]} (eager "
        f"{gc_res['eager_host_s']:.3f}), tokens, launches and rows equal to "
        f"the eager form's; prefill ms captured "
        f"{gc_res['prefill_ms_captured']:.2f} [eager "
        f"{gc_res['prefill_ms_eager']:.2f}]; two caches keep their own "
        f"prompts' rows; reserved GB after each call "
        f"{[round(c['reserved_gb'], 3) for c in gc_calls]} ({smi})")
    a3, a3_counts = run_switch_phase(smi, cfg, params, dev, gen)
    a3s, a3g, a3k = a3["switched"], a3["greedy"], a3["k1_rounds"]
    log(f"[4/6] a3. t_eff=None, Llama-7B Q4_0, {SWITCH_LEN}-row cache, "
        f"parent graph {a3['design']}: {SWITCH_PROMPT}-token prompt + "
        f"{SWITCH_STEPS} steps (lims {a3['lims']}: 3 buckets) in "
        f"{a3s['captures']} capture ({a3s['switch_bodies']} bodies, "
        f"{a3s['capture_s']:.2f} s) and {a3s['replays']} replays of one "
        f"graph, no host sync; tokens and launches equal to the "
        f"t_eff-passing form's ({a3['bucketed']['captures']} graphs): host "
        f"{a3s['host_ms_per_step']:.3f} ms a step, {a3s['tok_s']:.1f} tok/s "
        f"[t_eff passed {a3['bucketed']['host_ms_per_step']:.3f} ms, "
        f"{a3['bucketed']['tok_s']:.1f} tok/s]; greedy step "
        f"{a3g['host_ms_per_step']:.3f} ms; k1 rounds at t_eff = d_eff = None"
        f": {a3k['switched']['rounds']} rounds (target lims "
        f"{a3k['bucketed']['lims']}), {a3k['switched']['captures']} capture "
        f"({a3k['switched']['switch_bodies']} bodies, "
        f"{a3k['switched']['capture_s']:.2f} s), host "
        f"{a3k['switched']['host_ms_per_round']:.2f} ms a round, "
        f"{a3k['switched']['tok_s']:.1f} tok/s [t_eff passed "
        f"{a3k['bucketed']['host_ms_per_round']:.2f} ms, "
        f"{a3k['bucketed']['tok_s']:.1f} tok/s], tokens and launches equal "
        f"({smi})")
    a3b, a3c = a3["bucketed"], a3["if_chain"]
    log(f"[4/6] a3. windows of {SWITCH_PROFILE_STEPS} steps from "
        f"length {SWITCH_PROMPT + SWITCH_PROFILE_AT}, switched [t_eff "
        f"passed]: ms a step {a3s['window_ms_per_step']:.3f} "
        f"[{a3b['window_ms_per_step']:.3f}], traced device ms a step "
        f"{a3s['profile']['device_ms_per_step']} "
        f"[{a3b['profile']['device_ms_per_step']}], kernels a step "
        f"{a3s['profile']['kernels_per_step']} "
        f"[{a3b['profile']['kernels_per_step']}], idle share "
        f"{a3s['device_idle_share']} [{a3b['device_idle_share']}]; host ms "
        f"a step to issue {a3s['issue_ms_per_step']:.3f} "
        f"[{a3b['issue_ms_per_step']:.3f}] of {a3s['host_ms_per_step']:.3f} "
        f"[{a3b['host_ms_per_step']:.3f}]; the if-chain parent "
        f"({a3c['design']}, -DGS_SWITCH=0): tokens and launches equal to the "
        f"switch node's, host {a3c['host_ms_per_step']:.3f} ms a step, "
        f"window {a3c['window_ms_per_step']:.3f} ({smi})")
    eng, serve, serve_toks = run_serving(cfg, params)
    serve_counts = serve["launches"]
    # the main settings again (Q8_0 activations), an INT8 cache whose
    # rounding a one-ulp difference can move a whole step, like a Q8 one:
    # tol 0.1, as for the b = 1 path
    replay_err, serve_prof = replay_serving(cfg, params, tol=0.1)
    http = http_check(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    log(f"[4/6] b. serving: {serve['requests']} requests through "
        f"{SLOTS} slots, launches {serve_counts} (the eager form's tokens "
        f"and launches equal: {serve['tokens_equal_eager']}; "
        f"{serve['captures']} captures, {serve['capture_s']:.3f} s); replay "
        f"vs plain max abs err {replay_err:.3g}; HTTP: {http['requests']} "
        f"requests answered")

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
        _, c2counts = run_gpt2_per_op(tag, gcfg, gparams, gprompt)
        gcounts = {k: v + c2counts[k] for k, v in gcounts.items()}
        g_models[tag] = (gcfg, gparams, gprompt, gcounts, gpeak)
        log(f"[4/6] c. GPT-2 {tag} Q8_0: {PROMPT_LEN}-token prompt + {N_NEW} "
            f"greedy tokens through the kernels, then c2 (head-major cache, "
            f"the per-op route) + {MLP_STEPS}; launches {gcounts}; vs "
            f"plain max abs err {e1:.3g} (path settings), {e2:.3g} "
            f"(weight-only, f32 cache)")

    # d. Llama-7B through the fused routes. Both switches, flat bf16 cache:
    # the prompt on the per-op loop (wqkv, wo and the LM head through the
    # Q4_0 kernel, flash, the fused MLP at 16 rows), every decode step one
    # whole-block call a layer and the LM head.
    L = cfg.n_layer
    ftoks, fcounts = run_fused_path(
        cfg, params_d, prompt, "mlp_fused + layer_fused, flat bf16 cache",
        N_NEW, {"llama_layer": L * N_NEW, "flash_attn": L,
                # the prompt's 16 rows: kernel 9's multi-row instance
                **dq_launches("mlp_fused_silu_q4", L, 0),
                **dq_launches("matmul_q4_0", 2 * L + 1, N_NEW)},
        flat=True)
    # The fused MLP alone, head-major cache (path a's route with one call
    # in place of w_gate_up, silu and w_down): kernel 9 at b = 1.
    params_m = strip_routes(params_d, ("layer_fused",))
    mtoks, mcounts = run_fused_path(
        cfg, params_m, prompt, "mlp_fused, head-major bf16 cache", MLP_STEPS,
        {"flash_attn": L, **dq_launches("mlp_fused_silu_q4", L, L * MLP_STEPS),
         **dq_launches("matmul_q4_0", 2 * L + 1, (2 * L + 1) * MLP_STEPS)})
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
            {**dq_launches("matmul_q", 4 * L + 1, (4 * L + 1) * N_NEW),
             "flash_attn": L, "attn_decode": L * N_NEW},
            tag="llama_kquant_path", int8=True)
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
    release_graphs()  # path f's trees are gone
    log(f"[4/6] f. Llama-7B widths, {F_LAYERS} layers, {PROMPT_LEN}-token "
        f"prompt + {F_NEW} tokens: f1 {', '.join(A_FORMATS[:5])} (matmul_q), "
        f"f2 GGML_TPU_INT_DOT=1 {', '.join(B_FORMATS)}; launches "
        f"{fmt_counts}; vs plain max abs err {max(f_cmp.values()):.3g}")

    # g. training: GPT-2 124M, bf16, TRAIN_STEPS Adam steps through
    # optim.opt_fn, the cached flash entry's Function in every layer
    train, g_counts, g_state = run_train_path(dev, smi, gpt2.GPT2_124M)
    log(f"[4/6] g. GPT-2 124M training, B {TRAIN_B} x S {TRAIN_S}: losses "
        f"{[round(x, 4) for x in train['losses']]} -> "
        f"{train['loss_after']:.4f} (the eager form's within "
        f"{train['loss_rel_err_vs_eager']:.3g}); {train['captures']} capture "
        f"({train['capture_s']:.2f} s), {train['replays']} replays; flash "
        f"launches a step {train['flash_launches_per_step']:.0f} (both "
        f"forms); launches {g_counts}")
    # h. the graph layer: Test3 by ggml_opt (L-BFGS), a flash decoder's
    # forward, backward and opt() (the uncached entry)
    h1 = run_graph_test3(dev, smi)
    h2cmp, h2, h_counts = run_graph_decoder(dev, gen, smi)
    log(f"[4/6] h. graph layer: Test3 {h1['jit']['result']} (both forms), "
        f"weights within {h1['max_abs_weight_diff_jit_host']:.3g} of each "
        f"other; Rosenbrock on the card as on the CPU "
        f"{ {k: v['iterations'] for k, v in h1['rosenbrock'].items()} }; "
        f"capture failure raised; decoder "
        f"kernel vs plain loss err {h2cmp['loss_rel_err']:.3g}, grad rel L2 "
        f"{h2cmp['grad_rel_l2_max']:.3g}; backward graph "
        f"{h2cmp['backward_graph_seconds']:.3f} s with its capture, "
        f"{h2cmp['second_compute']['seconds']:.4f} s replayed after set_data "
        f"(captures {h2cmp['second_compute']['captures']}) [eager "
        f"{h2cmp['backward_graph_seconds_eager']:.3f} s], copies "
        f"{h2cmp['output_copy_bytes'] / 1e6:.1f} MB out, "
        f"{h2cmp['input_copy_bytes'] / 1e6:.1f} MB in a compute; opt() "
        f"losses {[round(x, 5) for x in h2['losses']]} in "
        f"{h2['seconds']:.3f} s [eager {h2['eager']['seconds']:.3f} s]; "
        f"launches {h_counts}")
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
        f"gain {tcheck['gain_b1_median']:.3f} at b = 1; lookup "
        f"{tcheck['lookup_us_per_launch']:.2f} us a launch")
    i_dec, i_counts = run_13b_path(dev, gen, smi)
    release_graphs()  # path i's tree is gone
    log(f"[4/6] i. LLAMA_13B Q4_0 ({I_LAYERS} layers): {PROMPT_LEN}-token "
        f"prompt + {I_NEW} "
        f"greedy tokens, launches {i_counts}; geometry by shape "
        f"{ {k: v['geometry'] for k, v in i_dec['geometry_by_shape'].items()} }"
        f"; {i_dec['window_tok_s']:.2f} tok/s, {i_dec['roofline_share']:.4f} "
        f"of the HBM roofline, device idle share "
        f"{i_dec['device_idle_share']}")

    # j. a model from files: path a's tree through a GGUF with a vocabulary
    # (j1), path c's 124M weights through HF safetensors (j2), path g's
    # trained parameters through a checkpoint (j3)
    t0 = time.perf_counter()
    j1, j1_counts = run_gguf_path(smi, repo, cfg, params, prompt, toks)
    j2, j2_counts = run_hf_path(smi, *g_models["124M"][:3])
    j3, j3_counts = run_checkpoint_path(smi, dev, g_state)
    del g_state
    release_graphs()  # path j's trees are gone
    j_counts = {k: j1_counts[k] + j2_counts[k] + j3_counts[k] for k in counts}
    log(f"[4/6] j. from files in {time.perf_counter() - t0:.1f} s: j1 "
        f"Llama-7B Q4_0 GGUF {j1['file_bytes'] / 1e9:.3f} GB written at "
        f"{j1['write_gb_s']:.2f} GB/s, loaded at {j1['load_gb_s']:.2f} GB/s "
        f"(warm), {j1['tensors']} wire digests equal, path a's {N_NEW} "
        f"tokens and prompt logits bit for bit, text "
        f"{j1['text'][:60]!r}; perplexity {J_CHUNKS} x {J_CHUNK} tokens "
        f"{j1['perplexity_default']['ppl']:.4g} "
        f"({j1['perplexity_default']['chunk_ms']:.1f} ms a chunk, its "
        f"capture included; "
        f"{j1['perplexity_default']['window_ms_replayed']:.1f} replayed; "
        f"eager {j1['perplexity_default']['eager_chunk_ms']:.1f}), "
        f"weight-only vs plain NLL err "
        f"{j1['perplexity_weight_only']['max_abs_nll_err']:.3g}; HTTP text "
        f"{j1['http']['text'][:40]!r}; j2 GPT-2 124M safetensors "
        f"{j2['file_bytes'] / 1e9:.3f} GB at {j2['write_gb_s']:.2f} / "
        f"{j2['load_gb_s']:.2f} GB/s, Q8_0 on the card, tokens equal: "
        f"{j2['tokens_equal_in_memory_route']}; j3 checkpoint of "
        f"{j3['leaves']} leaves bit-equal, loss {j3['loss']:.6f}; launches "
        f"{ {k: v for k, v in j_counts.items() if v} } ({smi})")

    # k. speculative decoding: k1 Llama-7B draft = target at b = 1, k2 GPT-2
    # 774M with a 124M draft, k3 the speculative engine over path b's config;
    # l. GPT-J 6B Q4_0 at b = 1 and through a GGUF
    t0 = time.perf_counter()
    k1, k1_counts = run_spec_k1(smi, cfg, params, prompt, toks)
    (_, g774p, g774prompt, *_), (_, g124p, *_) = (g_models["774M"],
                                                   g_models["124M"])
    k2, k2_counts = run_spec_k2(smi, g_models["774M"][0], g774p,
                                g_models["124M"][0], g124p, g774prompt)
    k3, k3_counts, k3_http = run_spec_serving_k3(smi, cfg, params, serve_toks)
    k_counts = {k: k1_counts[k] + k2_counts[k] + k3_counts[k] for k in counts}
    # captured.COUNTS of the phase's captured runs (k2 greedy and sampled)
    k_cap = {key: sum(r["forms"]["captured"][key] for r in
                      (k1, k2, k2["sampled"], k3))
             for key in ("captures", "replays", "capture_s")}
    emit({"spec_captured_counts": k_cap})

    def rate(r):  # captured [eager] tok/s
        return (f"{r['forms']['captured']['tok_s']:.2f} "
                f"[{r['forms']['eager']['tok_s']:.2f}]")

    log(f"[4/6] k. speculative decoding in {time.perf_counter() - t0:.1f} "
        f"s, k = {SPEC_K}, each run captured [eager], tokens and launches "
        f"equal: k1 Llama-7B draft = target {k1['rounds']} rounds, "
        f"{k1['mean_tokens_a_round']:.2f} tokens a round, {rate(k1)} tok/s "
        f"(a second call {k1['second_call']['tok_s']:.2f} tok/s, "
        f"{k1['second_call']['captures']} captures, tokens equal), "
        f"path a's tokens {k1['tokens_equal_path_a']}/{N_NEW} "
        f"(first parting {k1['first_parting']}); k2 GPT-2 774M + 124M draft "
        f"{k2['mean_tokens_a_round']:.2f} tokens a round, {rate(k2)} tok/s, "
        f"the per-op reference's tokens "
        f"{k2['tokens_equal_reference']}/{N_NEW}, sampled n_emit "
        f"{k2['sampled']['n_emit']} {rate(k2['sampled'])} tok/s (captured "
        f"stream = eager: {k2['sampled']['eager_tokens_equal']}); k3 "
        f"serving {k3['requests']} requests {rate(k3)} tok/s, "
        f"{k3['mean_tokens_a_round']:.2f} tokens a round, partings from the "
        f"plain engine {len(k3['partings_from_plain_engine'])}, share equal "
        f"to path b {k3['share_equal_path_b']:.3f}, HTTP "
        f"{k3_http['requests']} answered; captured.COUNTS {k_cap}; launches "
        f"{({k: v for k, v in k_counts.items() if v})} ({smi})")
    t0 = time.perf_counter()
    l_res, l_counts = run_gptj_path(smi, dev, gen)
    twins.close()
    log(f"[4/6] l. GPT-J 6B Q4_0 ({GPTJ_LAYERS} layers) in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{PROMPT_LEN}-token prompt + {N_NEW} greedy tokens, vs plain max "
        f"abs err {l_res['vs_plain_max_abs_err']}, GGUF "
        f"{l_res['gguf_bytes'] / 1e9:.3f} GB round trip bit-equal, tokens "
        f"equal; {l_res['decode']['window_tok_s']:.2f} tok/s, "
        f"{l_res['decode']['roofline_share']:.4f} of the HBM roofline; "
        f"launches {({k: v for k, v in l_counts.items() if v})} ({smi})")

    tw = {"calls": len(TWINS), "tokens": sum(t["n_tokens"] for t in TWINS),
          "all_equal": all(t["tokens_equal"] and t["launches_equal"]
                           for t in TWINS),
          "captures": sum(t["captures"] for t in TWINS),
          "replays": sum(t["replays"] for t in TWINS),
          "capture_s": sum(t["capture_s"] for t in TWINS),
          "warmup_s": sum(t["warmup_s"] for t in TWINS)}
    emit({"captured_twins": tw, "calls": TWINS})
    log(f"[4/6] captured generate: {tw['calls']} greedy calls of paths a-l "
        f"({tw['tokens']} tokens) equal to their eager twins in tokens and "
        f"launches: {tw['all_equal']}; {tw['captures']} captures "
        f"({tw['capture_s']:.2f} s, of it warm-up {tw['warmup_s']:.2f} s), "
        f"{tw['replays']} replays")
    release_graphs()  # path l's tree is gone

    # m. the perplexity chain (m1) and KV quality over its model (m2); n. the
    # user examples, OpProfiler and optax_compat
    import shutil

    t0 = time.perf_counter()
    mdir = scratch_dir(2**27)
    try:
        m1, m1_counts, (m_path, m_text) = run_chain_m1(smi, repo, dev, mdir)
        t_m1 = time.perf_counter() - t0
        m2, m2_counts = run_kvq_m2(smi, dev, m_path, m_text)
        t_m = time.perf_counter() - t0
        n_res, n_counts = run_examples_n(smi, repo, dev, gen, mdir)
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    t_mn = time.perf_counter() - t0
    log(f"[4/6] m1. ppl chain (seed 0, {m1['steps']} Adam steps over "
        f"{m1['train_chunks']} chunks, {m1['scored']} scored) in {t_m1:.1f} "
        f"s: ppl_fp {m1['ppl_fp32']:.4f}, dppl "
        f"{ {k: round(v, 4) for k, v in m1['dppl'].items()} }, train "
        f"{m1['train_s']:.1f} s ({m1['step_ms']:.1f} ms a step, its capture "
        f"included; a 4-step run's median {m1['step_ms_median_2_4']:.2f} "
        f"[eager {m1['eager_step_ms_median_2_4']:.2f}] ms), captures "
        f"{m1['captures']} ({m1['capture_s']:.2f} s), replays "
        f"{m1['replays']}, nll "
        f"{m1['nll_start']:.3f} -> {m1['nll']:.3f}; vs plain "
        f"{ {k: float(f'{v:.3g}') for k, v in m1['ppl_rel_err_vs_plain'].items()} }"
        f"; launches {({k: v for k, v in m1_counts.items() if v})} ({smi})")
    log(f"[4/6] m2. KV quality ({m2['chunks']} x {m2['steps']} steps): "
        + "; ".join(f"{r['cache']} ppl {r['ppl']:.4f} dppl {r['dppl']:+.4f} "
                    f"agree {r['argmax_agree']:.4f}" for r in m2["rows"])
        + f"; vs plain {m2['ppl_rel_err_vs_plain']}; captured = eager "
        f"within {max(m2['ppl_rel_err_captured_vs_eager'].values()):.3g}, "
        f"argmax agreement equal; {m2['step_ms']:.2f} "
        f"[eager {m2['eager_step_ms']:.2f}] ms a step, scoring included "
        f"({m2['captured_counts']['captures']} captures); launches "
        f"{({k: v for k, v in m2_counts.items() if v})} ({smi})")
    log(f"[4/6] n. examples and modules in {t_mn - t_m:.1f} s: serve "
        f"{ {k: (v['tokens'], round(v['seconds'], 2)) for k, v in n_res.items() if k.startswith('serve_')} }"
        f", http {len(n_res['http']['tokens'])} tokens, train_graph "
        f"{n_res['train_graph']}, graph_transformer "
        f"{n_res['graph_transformer']['tokens']}; OpProfiler "
        f"{n_res['profiler']['nodes']} nodes, rollup "
        f"{n_res['profiler']['rollup_us']}; GgmlAdam = opt_adam on "
        f"{list(n_res['optax_compat'])}; launches "
        f"{({k: v for k, v in n_counts.items() if v})}; m + n {t_mn:.1f} s "
        f"({smi})")

    # p. the parallel layer: p0 (NCCL, one rank), p1 (gloo, two ranks on
    # this card, Llama-7B Q4_0: TP serving, forward_pp, the ring prefill,
    # the overlapped matmul), p2 (gloo, four ranks: the dry run, the
    # distributed training example and its resume)
    p_res, p_counts = run_parallel_phase(smi, repo, cfg, params)

    q4_row, q4_mma_row = time_q4_0(dev, gen, counts)
    q4_row["max_abs_err"] = q4_mma_row["max_abs_err"] = q4_err
    gj_rows = time_weight_rows(dev, gen, "Q4_0", GPTJ_SHAPES, GPTJ_B)
    emit({"gptj_q4_0_timing": gj_rows})
    q4_row["gptj_b1_forward"] = forward_sum(gj_rows, "Q4_0", 1)
    q4_mma_row["gptj_b5_forward"] = forward_sum(gj_rows, "Q4_0", SPEC_K + 1)
    shapes = time_attention(dev, gen)
    fl = shapes["flash_attn"]["7b_prefill"]
    fl_row = {"name": "flash_attn", "route": "cuda",
              "source": "ggmlsharp_tpu_torch/csrc/flash_attn.cu",
              "replaces": "ggmlsharp_tpu/kernels/flash.py:104",
              "launches": counts["flash_attn"], "max_abs_err": fl_err,
              **{k: fl[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
              "attention_shapes": shapes["flash_attn"],
              "unit": "one prefill launch: B=1 Hq=32 S=16 T=256 D=128 bf16 "
                      "KV (warm: the rows were just written)"}
    ft = time_flash_train(dev, gen)
    fl_row.update({
        "train_g_ms": ft["cached_ms"], "train_g_softcap_ms":
        ft["cached_softcap_ms"], "train_g_plain_ms": ft["plain_ms"],
        "train_g_library_ms": ft["sdpa_ms"],
        "train_g_bound_ms": ft["cached_bound_ms"], "bwd_ms": ft["bwd_ms"],
        "library_bwd_ms": ft["sdpa_bwd_ms"],
        "bwd_bound_ms": ft["bwd_bound_ms"], "bwd_bound_by": ft["bwd_bound_by"],
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
    ad = shapes["attn_decode"]
    ad_row = {"name": "attn_decode", "route": "cuda",
              "source": "ggmlsharp_tpu_torch/csrc/attn_decode.cu",
              "replaces": "ggmlsharp_tpu/kernels/attn_decode.py:108",
              "launches": serve_counts["attn_decode"], "max_abs_err": ad_err,
              **{k: ad["b8_T64"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
              "attention_shapes": ad, "ragged_max_abs_err": ragged_err,
              "unit": "one decode-step layer call: B=8 Hq=Hkv=32 D=128 T=64 "
                      "int8 KV, npast 63, cold L2; library = SDPA alone on a "
                      "bf16 head-major copy"}
    lay = time_attn_layout(dev, gen)
    ad_row["attn_layout_max_abs_err"] = attn_lay_err
    ad_row["attn_layout_ms"] = lay[0]["attn_layout_ms"]
    ad_row["heads_layout_bf16_ms"] = lay[0]["heads_layout_ms"]
    _, q8_row, q8_mma_row = time_q8_0(dev, gen, g_models["124M"][3])
    q8_row["max_abs_err"] = q8_mma_row["max_abs_err"] = q8_err
    _, mlp_row, mlp_mma_row = time_mlp_fused(dev, gen, g_models["124M"][3])
    mlp_row["max_abs_err"] = mlp_mma_row["max_abs_err"] = mlp_err
    layer_row = time_gpt2_layer(dev, gen)
    layer_row["max_abs_err"] = layer_err
    _, silu_row, silu_mma_row = time_mlp_fused_silu(dev, gen, mcounts)
    silu_row["max_abs_err"] = silu_mma_row["max_abs_err"] = silu_err
    llayer_row = time_llama_layer(dev, gen)
    llayer_row["max_abs_err"] = llayer_err
    mq_row, mq_mma_row = time_matmul_q(dev, gen, kq_counts)
    for row in (mq_row, mq_mma_row):
        row["max_abs_err"] = max(mq_errs.values())
        row["max_abs_err_by_format"] = mq_errs
    ib_row = time_int_dot(dev, gen, fmt_counts)
    ib_row["max_abs_err"] = max(ib_errs.values())
    ib_row["max_abs_err_by_format"] = ib_errs
    for T in (64, 2048):  # path e's shape, B = 1
        for k in ("ms", "bound_ms", "plain_ms", "library_ms"):
            ad_row[f"b1_T{T}_{k}"] = ad[f"b1_T{T}"][k]
    for kind in ("int8", "bf16"):  # path m2's step, the D 32 instance
        for k in ("ms", "bound_ms", "plain_ms", "library_ms"):
            ad_row[f"m2_{kind}_d32_{k}"] = ad[f"m2_{kind}_d32_T128"][k]
    gs_row.update(name="graph_switch", route="cuda",
                  source="ggmlsharp_tpu_torch/csrc/graph_switch.cu",
                  replaces="ggmlsharp_tpu/models/common.py:181 (lax.switch's "
                           "index; no pallas_call)",
                  max_abs_err=gs_err,
                  unit="one selector launch alone (graph_switch_select): 8 "
                       "slots' lengths, T 1024; in a parent graph it is one "
                       "node ahead of the body; plain = graph_switch."
                       "select_index; no library call computes it")
    rows = (q4_row, q4_mma_row, fl_row, ad_row, q8_row, q8_mma_row, mlp_row,
            mlp_mma_row, layer_row, silu_row, silu_mma_row, llayer_row, mq_row, mq_mma_row,
            ib_row, unc_row, *tune_rows(probes), gs_row)
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
        row["launches_io_j"] = j_counts[name]
        row["launches_spec_k1"] = k1_counts[name]
        row["launches_spec_k2"] = k2_counts[name]
        row["launches_spec_k3"] = k3_counts[name]
        row["launches_gptj_l"] = l_counts[name]
        row["launches_chain_m1"] = m1_counts[name]
        row["launches_kvq_m2"] = m2_counts[name]
        row["launches_examples_n"] = n_counts[name]
        row["launches_parallel_p"] = p_counts[name]
        row["launches_switch_a3"] = a3_counts[name]
        # the count on the first main path that runs the kernel
        row["launches"] = next(c[name] for c in (counts, serve_counts, g124,
                                                 fcounts, mcounts, kq_counts,
                                                 fmt_counts, g_counts,
                                                 h_counts, gs_counts,
                                                 probe_counts, i_counts,
                                                 j_counts, k1_counts,
                                                 k2_counts, k3_counts,
                                                 l_counts, m1_counts,
                                                 m2_counts, n_counts,
                                                 p_counts, a3_counts)
                               if c[name])
    log("[5/6] kernel times taken")

    llama_wbytes = sum(v.nbytes() for blk in params["blocks"] for key, v in
                       blk.items() if key.startswith("w")) \
        + params["output"].nbytes()
    dec = decode_forms(llama, cfg, params, prompt, llama_wbytes,
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
           "captures": serve["captures"], "replays": serve["replays"],
           "capture_s": serve["capture_s"],
           "roofline_tok_s": serve_roof,
           "roofline_share": tok_s / serve_roof,
           "decode_step": serve_prof, "eager": serve["eager"]}
    emit({"serving": srv})
    ed, es = dec["eager"], serve["eager"]
    log(f"[6/6] decode b=1, captured (eager): {dec['window_tok_s']:.1f} "
        f"({ed['window_tok_s']:.1f}) tok/s, step median "
        f"{dec['step_ms_median']:.3f} ({ed['step_ms_median']:.3f}) ms, "
        f"{dec['roofline_share']:.3f} of the HBM roofline, device idle "
        f"share {dec['device_idle_share']} ({ed['device_idle_share']}); "
        f"serving {SLOTS} slots: {tok_s:.1f} ({es['tokens_per_s']:.1f}) "
        f"tok/s, {srv['roofline_share']:.4f} of the batched roofline, mean "
        f"TTFT {st['mean_ttft_s']:.2f} s, mean latency "
        f"{st['mean_latency_s']:.2f} s, peak {serve['peak_mem_gb']:.2f} "
        f"({es['peak_mem_gb']:.2f}) GB; its decode step "
        f"{serve_prof['untraced_step_ms_median']:.3f} "
        f"({serve_prof['eager']['untraced_step_ms_median']:.3f}) ms ({smi})")
    kr = spec_round_forms(smi, cfg, params, prompt)
    kc, ke = kr["captured"], kr["eager"]
    log(f"[6/6] k1 round, captured [eager]: host {kc['round_ms_median']:.2f} "
        f"(p84 {kc['round_ms_p84']:.2f}) [{ke['round_ms_median']:.1f} (p84 "
        f"{ke['round_ms_p84']:.1f})] ms, device {kc['device_ms_per_round']} "
        f"[{ke['device_ms_per_round']}] ms, idle {kc['device_idle_share']} "
        f"[{ke['device_idle_share']}], {kc['tokens_a_round']:.2f} tokens a "
        f"round, steady {kc['steady_tok_s']:.1f} [{ke['steady_tok_s']:.2f}] "
        f"tok/s; capture {kc['captures']} graph(s) in "
        f"{kc['capture_s']:.2f} s ({smi})")
    waves = serving_waves(smi, cfg, params, serve_toks)
    log("[6/6] b over two waves on one engine, captured: " + "; ".join(
        f"wave {w + 1} TTFT mean {c['mean_ttft_s']:.3f} s, median "
        f"{c['median_ttft_s']:.3f}, {c['tokens_per_s']:.1f} tok/s, "
        f"{c['captures']} captures in {c['capture_s']:.3f} s"
        for w, c in enumerate(waves["captured"]))
        + f" (the eager form's one wave, phase 4 b: TTFT "
        f"{es['stats']['mean_ttft_s']:.2f} s) ({smi})")
    adm = admission_ms(smi, cfg, params)
    log("[6/6] admission prefill ms, captured [eager] (first call): "
        + "; ".join(f"{c['kind']} {c['requests']} x bucket {c['bucket']} "
                    f"{c['ms_median']:.2f} [{e['ms_median']:.1f}] "
                    f"({c['first_ms']:.0f} [{e['first_ms']:.0f}])"
                    for c, e in zip(adm["captured"], adm["eager"]))
        + f" ({smi})")
    fdec = decode_forms(llama, cfg, params_d, prompt, llama_wbytes,
                        cfg.n_head_kv * cfg.head_dim, flat=True)
    fdec.update(route="mlp_fused + layer_fused, flat bf16 cache", card=smi,
                llama_layer_share_of_step=llayer_row["ms"] * cfg.n_layer
                / fdec["step_ms_median"],
                unfused_window_tok_s=dec["window_tok_s"])
    emit({"llama_fused_decode": fdec})
    log(f"[6/6] Llama-7B whole-block route b=1, captured (eager): "
        f"{fdec['window_tok_s']:.1f} ({fdec['eager']['window_tok_s']:.1f}) "
        f"tok/s ({dec['window_tok_s']:.1f} unfused), "
        f"{fdec['roofline_share']:.4f} of the HBM roofline, step median "
        f"{fdec['step_ms_median']:.3f} "
        f"({fdec['eager']['step_ms_median']:.3f}) ms, device idle share "
        f"{fdec['device_idle_share']} "
        f"({fdec['eager']['device_idle_share']})")
    del params, params_d, params_m
    release_graphs()
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
    release_graphs()
    for tag, (gcfg, gparams, gprompt, _, gpeak) in g_models.items():
        gdec = (decode_forms if tag == "124M" else measure_decode)(
            gpt2, gcfg, gparams, gprompt, gpt2_weight_bytes(gparams),
            gcfg.n_embd)
        gdec.update(config=tag, peak_mem_gb=gpeak / 1e9, card=smi)
        emit({"gpt2_decode": gdec})
        ge = gdec.get("eager")
        log(f"[6/6] GPT-2 {tag} decode b=1: {gdec['window_tok_s']:.1f} "
            f"tok/s"
            + (f" (eager {ge['window_tok_s']:.1f})" if ge else "")
            + f", {gdec['roofline_share']:.4f} of the HBM roofline "
            f"({gdec['roofline_tok_s']:.0f} tok/s), step median "
            f"{gdec['step_ms_median']:.3f} ms"
            + (f" (eager {ge['step_ms_median']:.3f})" if ge else "")
            + f", device idle share {gdec['device_idle_share']}"
            + (f" (eager {ge['device_idle_share']})" if ge else ""))
    train["flash_share_of_step"] = ft["fwd_bwd_ms"] * gpt2.GPT2_124M.n_layer / (
        train["step_ms_median_2_4"])
    emit({"train": train})
    ge = train["eager"]
    log(f"[6/6] g. GPT-2 124M training B {TRAIN_B} x S {TRAIN_S} bf16, "
        f"captured [eager]: step median {train['step_ms_median_2_4']:.1f} "
        f"[{ge['step_ms_median_2_4']:.1f}] ms, replays "
        f"{train['profile']['traced_step_ms']:.1f} ms traced, "
        f"{train['tokens_per_s']:.0f} [{ge['tokens_per_s']:.0f}] tok/s, "
        f"{train['bf16_peak_share']:.4f} [{ge['bf16_peak_share']:.4f}] of "
        f"the bf16 dense peak, device idle share "
        f"{train['device_idle_share']} [{ge['device_idle_share']}], capture "
        f"{train['capture_s']:.2f} s, peak memory "
        f"{train['peak_mem_gb']:.2f} [{ge['peak_mem_gb']:.2f}] GB ({smi})")
    log(f"total {time.perf_counter() - t_start:.0f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "unit",
            "launches_llama_b1", "launches_serving", "launches_gpt2_124m",
            "launches_gpt2_774m", "launches_llama_fused",
            "launches_llama_mlp_fused", "launches_llama_kquant",
            "launches_llama_formats", "launches_train_g", "launches_graph_h",
            "launches_gpt2_int8_serving", "launches_tuning_probes",
            "launches_llama_13b", "launches_io_j", "launches_spec_k1",
            "launches_spec_k2", "launches_spec_k3", "launches_gptj_l",
            "launches_chain_m1", "launches_kvq_m2", "launches_examples_n",
            "launches_parallel_p", "launches_switch_a3")
    extra = ("attn_layout_max_abs_err", "attn_layout_ms",
             "heads_layout_bf16_ms",  # kernel 3's second lane map
             "b1_T64_ms", "b1_T64_bound_ms", "b1_T64_plain_ms",
             "b1_T64_library_ms", "b1_T2048_ms", "b1_T2048_bound_ms",
             "b1_T2048_plain_ms", "b1_T2048_library_ms",  # kernel 3, B = 1
             # kernel 3's D 32 instance at path m2's step
             *(f"m2_{kind}_d32_{k}" for kind in ("int8", "bf16")
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")),
             "q6_k_token", "w_gate_up_b1_ms", "w_gate_up_ms",
             # the multi-row instances (b8/b128: a serving tick and prefill)
             "b8_forward", "b128_forward", "q6_k_prompt", "w_gate_up_b16_ms",
             "max_abs_err_by_format", "forward_774m", "b2_forward", "rows_ms",
             "rows_library_ms", "rows_bound_ms",
             # kernel 2 at path g's shape: the cached entry, softcap, the
             # backward (the Function's dense recompute) against SDPA's
             "train_g_ms", "train_g_softcap_ms", "train_g_plain_ms",
             "train_g_library_ms", "train_g_bound_ms", "bwd_ms",
             "library_bwd_ms", "bwd_bound_ms", "bwd_bound_by",
             "softcap_gradient_max_abs_err",
             # kernels 2 and 3 at every shape a path runs them; ragged edges
             "attention_shapes", "ragged_max_abs_err",
             # sites 12-17 (the tuning probes)
             "prmt_ms", "by_shape_ms", "prmt_by_shape_ms",
             "i2f_bit_equal_prmt", "half2_err_over_bar", "half2_terms_t",
             "gb_s", "ms_1gib", "gb_s_1gib", "library_ms_1gib",
             "library_gb_s_1gib", "plain_ms_1gib", "bound_ms_1gib", "order",
             "row_default_ms", "row_tuned_ms", "by_shape",
             # kernel 10 at npast 2047 and without its products; kernel 11
             # at 774M and at every timed case; kernel 7 at every 7B shape
             "npast_2047", "no_matvec_ms", "gpt2_774m", "shapes",
             "shapes_ms", "shapes_bound_ms",
             # kernels 8 and 9 at one row: their routes, their other shapes
             "fused_route_ms", "unfused_ms", "one_row_ms",
             # kernel 1 at GPT-J 6B's shapes: a token (b = 1), a verify (5)
             "gptj_b1_forward", "gptj_b5_forward",
             # the bucket switch's parent graph design and checked cases
             "design", "cases")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
