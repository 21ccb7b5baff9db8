"""Every parallel path on a small world (port of
ggmlsharp_tpu/parallel/dryrun.py): one sharded training step and one
sharded quantized decode step on a {data, model} mesh at tiny shapes, the
overlapped row-parallel matmul, a 1F1B pipelined training step, the
pipeline-parallel llama forward and tensor-parallel serving.

``run(n)`` spawns a gloo world of n ranks (every rank on ``device``: the
card unless the caller asks for the CPU) when no process group is up, and
runs in the current world of n ranks otherwise. Each step checks its
result against the unsharded computation on every rank, and raises if it
fails: the train step's loss before and after its update, the decode
step's logits, the overlapped matmul, the 1F1B loss and grads (against one
sequential autograd pass), the PP forward's logits and the TP engine's
tokens.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device


def _tiny_cfg(n_layer: int = 2):
    from ..models import llama

    return llama.LlamaConfig(n_vocab=512, n_ctx=64, n_embd=256, n_head=8,
                             n_head_kv=4, n_layer=n_layer, n_ff=512)


def _check(what, got, want, tol):
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        err = float((got - want).abs().max())
        raise SystemExit(f"dryrun: {what} off the unsharded computation by "
                         f"{err:.3g} (tolerance {tol})")


def _say(msg):
    if dist.get_rank() == 0:
        print(f"[dryrun] {msg}", flush=True)


def _steps(n: int, dev: torch.device):
    from ..dtypes import GType
    from ..models import llama, sampling
    from ..models.common import lm_loss
    from ..optim.tree import tree_leaves, tree_unflatten
    from ..quant.quantize import quantize
    from . import comm
    from . import sharding as shd
    from .mesh import make_axis_mesh, make_mesh
    from .overlap import row_parallel_mul_mat_overlapped
    from .pipeline import pipeline_train_step

    lr = 0.5  # large enough to move the loss by much more than the bar
    data = 2 if n % 2 == 0 and n > 2 else 1
    mesh = make_mesh(data=data, model=n // data)
    dax = comm.axis(mesh, "data")
    cfg = _tiny_cfg()
    B, S = data * 2, 16
    Bl = B // data
    gen = torch.Generator(dev).manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev, dtype=torch.float32)
    tokens = torch.randint(0, cfg.n_vocab, (B, S + 1), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    mine = tokens[dax.rank * Bl:(dax.rank + 1) * Bl]  # this data shard

    # --- one TP+DP training step: loss, grads averaged over data, SGD ----
    sp = shd.shard_params(params, shd.llama_param_specs(), mesh)
    leaves = tree_leaves(sp)
    for t in leaves:
        t.requires_grad_(True)
    loss = lm_loss(llama.forward, cfg, sp, mine)
    grads = torch.autograd.grad(loss, leaves)
    grads = [comm.all_reduce(g, dax) / data for g in grads]
    sp2 = tree_unflatten(sp, [(w - lr * g).detach()
                              for w, g in zip(leaves, grads)])
    with torch.no_grad():
        loss2 = float(lm_loss(llama.forward, cfg, sp2, mine))
    loss = comm.psum(float(loss.detach()), dax) / data
    loss2 = comm.psum(loss2, dax) / data
    # the unsharded step on the whole batch
    full = tree_leaves(params)
    for t in full:
        t.requires_grad_(True)
    want = lm_loss(llama.forward, cfg, params, tokens)
    wgrads = torch.autograd.grad(want, full)
    p2 = tree_unflatten(params, [(w - lr * g).detach()
                                 for w, g in zip(full, wgrads)])
    with torch.no_grad():
        want2 = float(lm_loss(llama.forward, cfg, p2, tokens))
    for what, a, b in (("loss", loss, float(want.detach())),
                       ("loss after the update", loss2, want2)):
        _check(f"sharded {what}", torch.tensor(a), torch.tensor(b), 1e-4)
    params = tree_unflatten(params, [t.detach() for t in full])
    _say(f"sharded train step ok on {n} ranks (mesh data={data}, "
         f"model={n // data}): loss {loss:.4f} -> {loss2:.4f}")

    # --- one TP+DP Q4_0 decode step over a sharded INT8 head-major cache --
    qparams = llama.quantize_params(params, GType.Q4_0)
    sq = shd.shard_params(qparams, shd.llama_param_specs(), mesh)
    prefill, step = sampling.make_decode_fns(llama.forward, cfg)

    def decode(tree, toks, c):
        with torch.no_grad():
            lg, c = prefill(tree, toks[:, :S].to(torch.int32), c)
            tok = torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)
            return step(tree, tok, c)[0], tok

    def cache():  # the batch over data, the heads over model
        return llama.new_cache(cfg, B, int8=True, flat=False, device=dev)

    logits, tok = decode(sq, mine, shd.shard_cache(
        cache(), shd.kv_cache_spec(), mesh))
    wlogits, wtok = decode(qparams, tokens, cache())
    rows = slice(dax.rank * Bl, (dax.rank + 1) * Bl)
    if logits.shape != (Bl, cfg.n_vocab) or \
            not torch.equal(tok, wtok[rows]):
        raise SystemExit(f"dryrun: decode logits {tuple(logits.shape)}, "
                         f"prompt tokens {tok.tolist()} != "
                         f"{wtok[rows].tolist()}")
    # Q8_0 activations: a one-ulp difference in the order of the sum over
    # ranks can move one activation by a whole Q8 step
    _check("sharded Q4_0 decode logits", logits, wlogits[rows], 2e-2)
    _say(f"sharded Q4_0 decode step ok: logits {tuple(logits.shape)} a "
         f"data shard")

    # --- the overlapped ring reduce-scatter matmul ------------------------
    g2 = torch.Generator(dev).manual_seed(3)
    w = torch.randn((256, 32 * n * 8), generator=g2, device=dev) * 0.1
    qw = quantize(w, GType.Q4_0)
    xx = torch.randn((2, w.shape[1]), generator=g2, device=dev)
    y = row_parallel_mul_mat_overlapped(qw, xx, mesh, axis="model")
    from .. import ops

    y0 = ops.mul_mat(qw, xx, quantize_acts=False)
    if not torch.allclose(y, y0, rtol=1e-4, atol=1e-4):
        raise SystemExit("dryrun: the overlapped matmul disagrees")
    _say(f"overlapped ring reduce-scatter matmul ok: {tuple(y.shape)}")

    # --- 1F1B pipelined training step over the model dim -------------------
    S_pp = n // data
    Lpp, Dpp = 2 * S_pp, 16
    g3 = torch.Generator(dev).manual_seed(5)
    pp_params = {"w": torch.randn((Lpp, Dpp, Dpp), generator=g3,
                                  device=dev) * 0.3}
    xpp = torch.randn((2 * S_pp, Dpp), generator=g3, device=dev)
    ypp = torch.randn((2 * S_pp, Dpp), generator=g3, device=dev)
    lpp, gpp = pipeline_train_step(
        lambda p, h: torch.tanh(h @ p["w"]),
        lambda o, t: torch.mean((o - t) ** 2), pp_params, xpp, ypp, mesh)
    w_seq = pp_params["w"].clone().requires_grad_(True)
    M = S_pp  # the default microbatch count
    total = 0.0
    for xm, ym in zip(xpp.chunk(M), ypp.chunk(M)):
        h = xm
        for j in range(Lpp):
            h = torch.tanh(h @ w_seq[j])
        total = total + torch.mean((h - ym) ** 2)
    want = total / M
    (gseq,) = torch.autograd.grad(want, [w_seq])
    _check("1F1B loss", torch.tensor(lpp), want.detach().cpu(), 1e-5)
    _check("1F1B grads", gpp["w"], gseq, 1e-5)
    _say(f"1F1B pipeline train step ok: loss={lpp:.4f}")

    # --- pipeline-parallel llama scoring forward over a pipe mesh ----------
    pipe = make_axis_mesh("pipe", n)
    pp_cfg = _tiny_cfg(n_layer=n)
    fp = llama.init_params(pp_cfg, torch.Generator(dev).manual_seed(8),
                           device=dev, dtype=torch.float32)
    pp_toks = torch.randint(0, pp_cfg.n_vocab, (4, 16), device=dev,
                            generator=torch.Generator(dev).manual_seed(9),
                            dtype=torch.int32)
    with torch.no_grad():
        pp_logits = llama.forward_pp(fp, pp_cfg, pp_toks, pipe, n_micro=2)
        pos = torch.arange(16, dtype=torch.int32, device=dev)[None].expand(
            4, 16)
        want, _ = llama.forward(fp, pp_cfg, pp_toks, llama.new_cache(
            pp_cfg, 4, dtype=torch.float32, device=dev), pos)
    _check("PP llama logits", pp_logits, want, 2e-4)
    _say(f"PP llama forward ok: logits {tuple(pp_logits.shape)} over {n} "
         f"stages")

    _run_serving(mesh, cfg, dev)


def _run_serving(mesh, cfg, dev):
    """The tensor-parallel continuous-batching engine on the mesh: a burst
    of admissions, a few ticks, the unsharded engine's tokens."""
    from ..models import llama
    from ..serving import Engine, Request
    from . import sharding as shd

    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(1),
                               device=dev, dtype=torch.float32)
    prompts = [[3, 7, 11], [5, 2], [9, 9, 9, 1]]

    def serve(p, m):
        eng = Engine(llama.forward, cfg, p, batch_slots=2,
                     cache_dtype=torch.float32, device=dev, mesh=m)
        for i, pr in enumerate(prompts):
            eng.submit(Request(id=i, prompt=pr, max_new_tokens=3))
        return eng.run()

    results = serve(shd.shard_params(params, shd.llama_param_specs(), mesh),
                    mesh)
    if not (len(results) == 3 and all(len(r.out_tokens) == 3 and
                                      r.error is None for r in results)):
        raise SystemExit(f"dryrun: serving results {results}")
    got = [r.out_tokens for r in results]
    want = [r.out_tokens for r in serve(params, None)]
    if got != want:
        raise SystemExit(f"dryrun: TP serving {got} != {want}")
    _say(f"TP serving engine ok: {got}")


def _rank(rank: int, n: int, device: str):
    _steps(n, torch.device(device))


def run(n_devices: int, device=None) -> None:
    """The dry run on n ranks (see the module docstring)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"need a world of {n_devices}, have "
                             f"{dist.get_world_size()}")
        return _steps(n_devices, dev)
    from .distributed import spawn

    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    spawn(_rank, n_devices, args=(n_devices, str(dev)), backend="gloo",
          device=dev if dev.type == "cuda" else None,
          threads=1 if dev.type == "cpu" else None)
