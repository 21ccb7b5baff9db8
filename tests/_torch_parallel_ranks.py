"""Rank-side code of the tests/test_torch_parallel_*.py files: run in the
small gloo worlds they spawn (parallel.distributed.spawn), one function a
world. It imports only torch, numpy and the port; every input is made from
a numpy seed or read from the file the test wrote, and every result is
written to ``out/<name>_<rank>.pt`` for the test to hold against the JAX
package and the unsharded port."""
import os

import numpy as np
import torch


def _save(out, name, rank, obj):
    torch.save(obj, os.path.join(out, f"{name}_{rank}.pt"))


def _plain(tree):
    """A sharded tree without its "tp" entry (a process group does not
    pickle)."""
    return {k: v for k, v in tree.items() if k != "tp"}


def _np(*shape, rng, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


# --- the primitives (4 ranks) -----------------------------------------------

def prim_inputs():
    """The inputs of the primitive checks, the same arrays tests and ranks
    make."""
    r1 = np.random.default_rng(1)
    ring_c = [_np(2, 2, 64, 16, rng=r1) for _ in range(3)]
    r2 = np.random.default_rng(2)
    ring_n = [_np(1, 2, 32, 8, rng=r2) for _ in range(3)]
    r5 = np.random.default_rng(5)
    pf = (_np(8, 16, 16, rng=r5, scale=0.3), _np(8, 16, rng=r5, scale=0.1),
          _np(8, 16, rng=r5))
    r6 = np.random.default_rng(6)
    p1 = (_np(4, 8, 8, rng=r6, scale=0.3), _np(4, 8, rng=r6))
    r23 = np.random.default_rng(23)
    tr = {"w": _np(8, 16, 16, rng=r23, scale=0.3),
          "b": _np(8, 16, rng=r23, scale=0.1)}
    tr_xy = {M: (_np(2 * M, 16, rng=r23), _np(2 * M, 16, rng=r23))
             for M in (4, 8)}
    r7 = np.random.default_rng(7)
    ov = (_np(512, 1024, rng=r7, scale=0.1), _np(2, 1024, rng=r7))
    return dict(ring_c=ring_c, ring_n=ring_n, pf=pf, p1=p1, tr=tr,
                tr_xy=tr_xy, ov=ov)


def prims(rank, out):
    from ggmlsharp_tpu_torch import GType, quantize
    from ggmlsharp_tpu_torch.kernels import config as kcfg
    from ggmlsharp_tpu_torch.parallel import (make_mesh, pipeline_forward,
                                              pipeline_train_step,
                                              ring_attention)
    from ggmlsharp_tpu_torch.parallel.overlap import \
        row_parallel_mul_mat_overlapped

    kcfg.set_mm_dot("f32")
    mesh = make_mesh(data=1, model=4)
    d = prim_inputs()
    res = {"ring_causal": ring_attention(*d["ring_c"], mesh, "model", True),
           "ring_full": ring_attention(*d["ring_n"], mesh, "model", False)}
    Ws, bs, x = d["pf"]
    res["pipe_m4"] = pipeline_forward(
        lambda lp, h: torch.tanh(h @ lp[0] + lp[1]), (Ws, bs), x, mesh,
        axis="model", n_micro=4)
    W1, x1 = d["p1"]
    res["pipe_m1"] = pipeline_forward(lambda W, h: h @ W, W1, x1, mesh,
                                      n_micro=1)
    for M, (xt, yt) in d["tr_xy"].items():
        res[f"1f1b_m{M}"] = pipeline_train_step(
            lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
            lambda o, t: torch.mean((o - t) ** 2), d["tr"], xt, yt, mesh,
            n_micro=M)
    w, xo = d["ov"]
    qw = quantize(w, GType.Q4_0)
    res["overlap_q4_0"] = row_parallel_mul_mat_overlapped(
        qw, xo, mesh, use_kernels=False)
    res["overlap_dense"] = row_parallel_mul_mat_overlapped(
        w, xo, mesh, use_kernels=False)
    _save(out, "prims", rank, res)


# --- the models (2 ranks) -----------------------------------------------------

def _trees(out):
    return torch.load(os.path.join(out, "trees.pt"), weights_only=False)


def models(rank, out):
    from ggmlsharp_tpu_torch.kernels import config as kcfg
    from ggmlsharp_tpu_torch.models import gpt2, llama
    from ggmlsharp_tpu_torch.parallel import (gpt2_param_specs, kv_cache_spec,
                                              llama_param_specs, make_mesh,
                                              set_sequence_mesh, shard_cache,
                                              shard_params)
    from ggmlsharp_tpu_torch.parallel.mesh import make_axis_mesh

    kcfg.set_mm_dot("f32")
    t = _trees(out)
    mesh = make_mesh(model=2)
    res = {}
    lcfg = llama.LlamaConfig(**t["llama_cfg"])
    lp = llama.params_from_jax(t["llama"], device="cpu")
    toks = torch.from_numpy(t["tokens"])
    B, S = toks.shape
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    for name, tree in (("llama", lp), ("llama_fused", llama.fuse_params(lp)),
                       ("llama_q4_0", llama.params_from_jax(t["llama_q4_0"],
                                                            device="cpu"))):
        sp = shard_params(tree, llama_param_specs(), mesh)
        cache = shard_cache(llama.new_cache(lcfg, B, dtype=torch.float32,
                                            device="cpu"),
                            kv_cache_spec(), mesh)
        with torch.no_grad():
            lg, cache = llama.forward(sp, lcfg, toks, cache, pos)
            # one decode step over the sharded cache
            nxt = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            lg2, _ = llama.forward(sp, lcfg, nxt, cache, pos[:, -1:] + 1)
        res[name] = (lg, lg2, nxt)
    gcfg = gpt2.GPT2Config(**t["gpt2_cfg"])
    gp = gpt2.params_from_jax(t["gpt2"], device="cpu")
    sg = shard_params(gp, gpt2_param_specs(), mesh)
    gt = toks % gcfg.n_vocab
    with torch.no_grad():
        res["gpt2"], _ = gpt2.forward(
            sg, gcfg, gt, shard_cache(gpt2.new_cache(
                gcfg, B, dtype=torch.float32, device="cpu"),
                kv_cache_spec(), mesh), pos)
    # pipeline-parallel scoring over a 2-stage pipe mesh, both layouts
    pcfg = llama.LlamaConfig(**t["pp_cfg"])
    pp = llama.params_from_jax(t["pp"], device="cpu")
    pipe = make_axis_mesh("pipe")
    ptoks = torch.from_numpy(t["pp_tokens"])
    with torch.no_grad():
        res["pp"] = llama.forward_pp(pp, pcfg, ptoks, pipe, n_micro=2)
        res["pp_fused"] = llama.forward_pp(llama.fuse_params(pp), pcfg, ptoks,
                                           pipe, n_micro=4)
        # the stage's own blocks only: the others may be None
        own = dict(pp, blocks=[b if i // 2 == rank else None
                               for i, b in enumerate(pp["blocks"])])
        res["pp_own"] = llama.forward_pp(own, pcfg, ptoks, pipe, n_micro=2)
    # the ring route: GGML_TPU_ATTN=ring over a 2-rank sequence mesh
    rtoks = torch.from_numpy(t["ring_tokens"])
    rB, rS = rtoks.shape
    rpos = torch.arange(rS, dtype=torch.int32)[None].expand(rB, rS)
    seq = make_axis_mesh("seq")
    set_sequence_mesh(seq, "seq")
    os.environ["GGML_TPU_ATTN"] = "ring"
    try:
        with torch.no_grad():
            res["ring_model"], _ = llama.forward(
                lp, lcfg, rtoks, llama.new_cache(lcfg, rB, dtype=torch.float32,
                                                 device="cpu"), rpos)
            res["ring_model_flat"], _ = llama.forward(
                lp, lcfg, rtoks, llama.new_cache(
                    lcfg, rB, dtype=torch.float32, flat=True, device="cpu"),
                rpos, cached_prefix=False)
    finally:
        os.environ.pop("GGML_TPU_ATTN", None)
        set_sequence_mesh(None)
    _save(out, "models", rank, res)


# --- serving (2 ranks) --------------------------------------------------------

def serving(rank, out):
    from ggmlsharp_tpu_torch.models import gpt2, llama
    from ggmlsharp_tpu_torch.parallel import (gpt2_param_specs,
                                              llama_param_specs, make_mesh,
                                              shard_params)
    from ggmlsharp_tpu_torch.serving import Engine, Request

    t = _trees(out)
    mesh = make_mesh(model=2)
    cfg = llama.TINY_LLAMA
    tp = llama.params_from_jax(t["llama"], device="cpu")
    dp = llama.params_from_jax(t["draft"], device="cpu")
    gcfg = gpt2.GPT2Config(**t["gpt2_cfg"])
    gp = gpt2.params_from_jax(t["gpt2"], device="cpu")

    def serve(fwd, c, p, prompts, n_new, m, prefix=None, **kw):
        eng = Engine(fwd, c, p, batch_slots=2, cache_dtype=torch.float32,
                     device="cpu", mesh=m, **kw)
        pid = eng.register_prefix(prefix) if prefix else None
        for i, pr in enumerate(prompts):
            eng.submit(Request(id=i, prompt=pr, max_new_tokens=n_new,
                               prefix_id=pid))
        got = {r.id: r.out_tokens for r in eng.run()}
        return got, (eng.cache.k[0].shape[1], eng.cache.is_flat)

    stp = shard_params(tp, llama_param_specs(), mesh)
    sdp = shard_params(dp, llama_param_specs(), mesh)
    sgp = shard_params(gp, gpt2_param_specs(), mesh)
    trees = {"llama": (llama.forward, cfg, tp, stp),
             "gpt2": (gpt2.forward, gcfg, gp, sgp)}
    res = {}
    for name, case in t["cases"].items():
        fwd, c, whole, shard = trees[case["model"]]
        kw = {}
        if case["spec_k"]:
            kw = dict(draft_forward=llama.forward, draft_cfg=cfg,
                      spec_k=case["spec_k"])
        args = (fwd, c)
        pr = (case["prompts"], case["n_new"])
        want, _ = serve(*args, whole, *pr, None, case["prefix"],
                        **(dict(kw, draft_params=dp) if kw else {}))
        got, layout = serve(*args, shard, *pr, mesh, case["prefix"],
                            **(dict(kw, draft_params=sdp) if kw else {}))
        res[name] = {"tp": got, "single": want, "cache": layout}
    # the layout follows the tree: a sharded tree without mesh= serves the
    # same, over the same head-major cache of the local heads
    res["no_mesh"] = serve(llama.forward, cfg, stp,
                           t["cases"]["llama"]["prompts"],
                           t["cases"]["llama"]["n_new"], None)
    # a tree that is not sharded, or sharded on another mesh, is refused
    other = make_mesh(data=2, model=1)
    refused = []
    for p in (tp, stp):
        try:
            Engine(llama.forward, cfg, p, batch_slots=2, device="cpu",
                   mesh=other if p is stp else mesh)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    res["refused"] = refused
    _save(out, "serving", rank, res)


# --- checkpoints, the loop (2 ranks) ------------------------------------------

def ckpt(rank, out):
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.io import checkpoint as ck
    from ggmlsharp_tpu_torch.models import llama
    from ggmlsharp_tpu_torch.parallel import (llama_param_specs, make_mesh,
                                              shard_params)
    from ggmlsharp_tpu_torch.parallel.distributed import CheckpointedLoop

    mesh = make_mesh(model=2)
    cfg = llama.LlamaConfig(n_vocab=300, n_ctx=64, n_embd=256, n_head=4,
                            n_head_kv=2, n_layer=2, n_ff=512)
    raw = llama.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    full = llama.quantize_params(raw, GType.Q4_0)
    full["blocks"][1]["wqkv"] = llama.fuse_params(raw)["blocks"][1]["wqkv"]
    sp = shard_params(full, llama_param_specs(), mesh)
    path = os.path.join(out, "ck")
    ck.save_checkpoint_sharded(path, sp, step=7)
    got, step = ck.load_checkpoint_sharded(path, like=sp)
    whole, wstep = ck.load_checkpoint_sharded(path, device="cpu")
    # a sharded tree refuses the single-device flat cache
    try:
        llama.forward(sp, cfg, torch.zeros((1, 1), dtype=torch.int32),
                      llama.new_cache(cfg, 1, flat=True, device="cpu"),
                      torch.zeros((1, 1), dtype=torch.int32))
        flat_refused = False
    except ValueError:
        flat_refused = True
    _save(out, "ckpt", rank, {"full": full, "shard": _plain(sp),
                              "got": _plain(got),
                              "got_tp": got["tp"] is sp["tp"],
                              "whole": whole, "steps": (step, wstep),
                              "flat_refused": flat_refused})

    # CheckpointedLoop over a sharded tree: 5 steps, then resume for 3
    def step_fn(state, i):
        return dict(state, norm=state["norm"] + 1.0)

    ldir = os.path.join(out, "loop")
    loop = CheckpointedLoop(step_fn, ldir, every=2)
    s1 = loop.run(loop.resume(sp), 5)
    loop2 = CheckpointedLoop(step_fn, ldir, every=2)
    s2 = loop2.resume(sp)
    resumed = loop2.step
    s3 = loop2.run(s2, 3)
    _save(out, "loop", rank, {"sharded": loop.sharded, "resumed": resumed,
                              "s1": s1["norm"], "s2": s2["norm"],
                              "s3": s3["norm"], "step": loop2.step,
                              "wq_equal": bool(torch.equal(
                                  s3["blocks"][0]["wo"]["qs"],
                                  sp["blocks"][0]["wo"]["qs"]))})


# --- the captured routes (2 ranks) --------------------------------------------

def _as_nccl(tree):
    """The tree's model axis reports the backend name "nccl" (the route
    stub: the collectives still run on gloo over CPU tensors)."""
    tree["tp"].axis.backend = "nccl"
    return tree


def _example(root):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_distributed_torch",
        os.path.join(root, "examples", "train_distributed_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRAIN_CFG = dict(n_vocab=512, n_ctx=64, n_embd=256, n_head=8, n_layer=2)


def train_tokens(rank):
    """Rank ``rank``'s data shard of the example's step: [2, 33] tokens."""
    return np.random.default_rng(rank).integers(
        0, TRAIN_CFG["n_vocab"], (2, 33)).astype(np.int64)


def captured_routes(rank, out, root):
    """Engine(mesh=) and the training example's step through their
    CapturedStep route (the backend names stubbed to "nccl"; on the CPU a
    CapturedStep runs eagerly through its static buffers), and the route
    each backend name gives. The example's state starts from the JAX
    example's init (trees.pt's "gpt2_train")."""
    import contextlib

    from ggmlsharp_tpu_torch.models import captured, gpt2, llama
    from ggmlsharp_tpu_torch.models.captured import CapturedStep
    from ggmlsharp_tpu_torch.models.common import params_from_jax
    from ggmlsharp_tpu_torch.optim.tree import tree_leaves
    from ggmlsharp_tpu_torch.parallel import (comm, gpt2_param_specs,
                                              llama_param_specs, make_mesh,
                                              shard_params)
    from ggmlsharp_tpu_torch.serving import Engine, Request

    t = _trees(out)
    mesh = make_mesh(model=2)
    cfg = llama.TINY_LLAMA
    tp = llama.params_from_jax(t["llama"], device="cpu")
    res = {}

    def engine(tree):
        return Engine(llama.forward, cfg, tree, batch_slots=2,
                      cache_dtype=torch.float32, device="cpu", mesh=mesh)

    gloo = engine(shard_params(tp, llama_param_specs(), mesh))
    res["gloo_engine"] = (gloo.captured, isinstance(gloo._decode,
                                                    CapturedStep))
    eng = engine(_as_nccl(shard_params(tp, llama_param_specs(), mesh)))
    res["nccl_engine"] = (eng.captured, all(
        isinstance(s, CapturedStep) for s in (eng._decode, eng._prefill_one,
                                              eng._prefill_rows)))
    case = t["cases"]["llama"]
    for i, p in enumerate(case["prompts"]):
        eng.submit(Request(id=i, prompt=p, max_new_tokens=case["n_new"]))
    res["tokens"] = {r.id: r.out_tokens for r in eng.run()}

    # the example's step on a data mesh, both forms from one state
    ex = _example(root)
    dmesh = make_mesh(data=2, model=1)
    gcfg = gpt2.GPT2Config(**TRAIN_CFG)
    toks = torch.from_numpy(train_tokens(rank))

    def run(form, n=3):
        state = shard_params(params_from_jax(t["gpt2_train"], device="cpu"),
                             gpt2_param_specs(), dmesh)
        dax = comm.axis(dmesh, "data")
        if form != "gloo":
            _as_nccl(state)
            dax.backend = "nccl"
        step, route = ex.sgd_step(gcfg, state, toks, dax, 2)
        leaves = tree_leaves(state)
        ptrs = [w.data_ptr() for w in leaves]
        before = [w.clone() for w in leaves]
        with captured.disabled() if form == "eager" else \
                contextlib.nullcontext():
            losses = [float(step()) for _ in range(n)]
        in_place = [w.data_ptr() for w in leaves] == ptrs and all(
            not torch.equal(w, b) for w, b in zip(leaves, before))
        return {"losses": losses, "captured": route, "in_place": in_place,
                "state": [w.clone() for w in leaves]}

    res["train"] = {form: run(form) for form in ("captured", "eager",
                                                 "gloo")}
    _save(out, "captured_routes", rank, res)
