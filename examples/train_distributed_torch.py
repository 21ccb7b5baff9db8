"""Sharded training with checkpoint-resume, with the PyTorch/CUDA port:
tensor- and data-parallel GPT-2 on a {data, model} mesh, driven by the
CheckpointedLoop (sharded checkpoints, resume from the newest).

    torchrun --nproc-per-node N examples/train_distributed_torch.py \
        [--steps 30] [--ckpt DIR] [--data D] [--model M]
    python examples/train_distributed_torch.py --world 4 [--device cpu]

Under torchrun each rank takes its card (LOCAL_RANK) and the world is an
NCCL one. Without torchrun, --world N spawns N ranks on this host joined by
gloo, every one on the card (or the CPU with --device cpu). Runs on the card
unless --device cpu.

The step is JAX's jitted ``sgd_step`` (examples/train_distributed.py): the
forward and backward, the gradients summed over ``data`` (all_reduce), the
SGD update written in place into the state's tensors and the loss averaged
over ``data`` on the device; the host reads the loss once a step, after
the step, as JAX's ``float(loss)`` does. Over NCCL the step is one
``models.captured.CapturedStep`` (one CUDA graph, the collectives recorded
in it); over gloo, whose collectives stage CUDA tensors through the host,
it runs eagerly (``sgd_step``'s route, fixed by the backends' names), as it
does inside ``captured.disabled()``. The loop resumes by copying the
checkpoint into the state's own tensors (``resume(in_place=True)``), which
the graph reads. The captured step is checked on a world of one NCCL rank
only; over two or more ranks it is unchecked (``captured.disabled()`` gives
the eager form).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ggml_torch_train_ck"))
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--model", type=int, default=None)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def sgd_step(cfg, state, tokens, dax, n_data: int, lr: float = 0.1):
    """JAX's jitted sgd_step over ``state`` (a sharded parameter tree):
    (step() -> the loss averaged over ``data``, a 0-d f32 tensor on the
    device; the state's tensors updated in place, captured) where captured
    says whether the step is one CUDA graph (NCCL groups) or runs eagerly
    (gloo). ``tokens`` [b, S + 1]: this rank's data shard."""
    import torch

    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.models.captured import CapturedStep
    from ggmlsharp_tpu_torch.models.common import capturable, lm_loss
    from ggmlsharp_tpu_torch.optim.tree import tree_leaves, tree_unflatten
    from ggmlsharp_tpu_torch.parallel import comm

    leaves = tree_leaves(state)

    def body(toks):
        ps = [w.detach().requires_grad_(True) for w in leaves]
        loss = lm_loss(gpt2.forward, cfg, tree_unflatten(state, ps), toks)
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w.sub_(lr * comm.all_reduce(g, dax) / n_data)
            return comm.all_reduce(loss.detach(), dax) / n_data

    captured = capturable(state) and dax.backend != "gloo"
    run = CapturedStep(body, state=tuple(leaves)) if captured else body
    return (lambda: run(tokens)), captured


def train(args, device) -> dict:
    """The training run on this rank of an initialized world: the losses
    of the steps it ran, whether its step was captured and the step it
    resumed at."""
    import torch
    import torch.distributed as dist

    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.parallel import (gpt2_param_specs, make_mesh,
                                              mesh_shape, shard_params)
    from ggmlsharp_tpu_torch.parallel import comm
    from ggmlsharp_tpu_torch.parallel.distributed import CheckpointedLoop

    mesh = make_mesh(data=args.data, model=args.model)
    rank0 = dist.get_rank() == 0
    if rank0:
        print("mesh:", mesh_shape(mesh), flush=True)
    dax = comm.axis(mesh, "data")
    cfg = gpt2.GPT2Config(n_vocab=512, n_ctx=64, n_embd=256, n_head=8,
                          n_layer=2)
    n_data = mesh_shape(mesh)["data"]
    B, S = 2 * n_data, 32
    params = gpt2.init_params(cfg, torch.Generator(device).manual_seed(0),
                              device=device, dtype=torch.float32)
    params = shard_params(params, gpt2_param_specs(), mesh)
    data = torch.randint(0, cfg.n_vocab, (B, S + 1), device=device,
                         generator=torch.Generator(device).manual_seed(1))
    mine = data[dax.rank * 2:(dax.rank + 1) * 2]  # this rank's data shard
    step, captured = sgd_step(cfg, params, mine, dax, n_data)
    losses = []

    def step_fn(state, i):
        losses.append(float(step()))  # one read a step, after it
        return state

    loop = CheckpointedLoop(step_fn, args.ckpt, every=10)
    loop.resume(params, in_place=True)
    resumed = loop.step
    if rank0:
        print(f"resumed at step {resumed}; the step "
              f"{'captured' if captured else 'eager'}", flush=True)
    loop.run(params, args.steps)
    if rank0:
        print(f"step {loop.step}: loss {losses[0]:.4f} -> {losses[-1]:.4f}",
              flush=True)
        print(f"checkpoints in {args.ckpt}: "
              f"{sorted(os.listdir(args.ckpt))[-1]}", flush=True)
    return {"losses": losses, "captured": captured, "resumed_at": resumed}


def _rank(rank, args, device):
    import torch

    train(args, torch.device(device))


def main(argv=None):
    args = parse(argv)
    import torch

    from ggmlsharp_tpu_torch import resolve_device
    from ggmlsharp_tpu_torch.parallel.distributed import initialize, spawn

    dev = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:  # torchrun
        import torch.distributed as dist

        if not initialize(device=dev):  # a world of one: still a group
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method="env://")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        train(args, dev)
        dist.destroy_process_group()
        return 0
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    # the ranks import this file by its module name
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from train_distributed_torch import _rank

    spawn(_rank, args.world, args=(args, str(dev)), backend="gloo",
          device=dev if dev.type == "cuda" else None,
          threads=1 if dev.type == "cpu" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
