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


def train(args, device) -> list:
    """The training run on this rank of an initialized world; returns the
    losses of the steps it ran."""
    import torch
    import torch.distributed as dist

    from ggmlsharp_tpu_torch.models import gpt2
    from ggmlsharp_tpu_torch.models.common import lm_loss
    from ggmlsharp_tpu_torch.optim.tree import tree_leaves, tree_unflatten
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
    losses = []

    def step_fn(state, step):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(state)]
        tree = tree_unflatten(state, leaves)
        loss = lm_loss(gpt2.forward, cfg, tree, mine)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(comm.psum(float(loss.detach()), dax) / n_data)
        return tree_unflatten(state, [
            (w - 0.1 * comm.all_reduce(g, dax) / n_data).detach()
            for w, g in zip(leaves, grads)])

    loop = CheckpointedLoop(step_fn, args.ckpt, every=10)
    state = loop.resume(params)
    if rank0:
        print(f"resumed at step {loop.step}", flush=True)
    loop.run(state, args.steps)
    if rank0:
        print(f"step {loop.step}: loss {losses[0]:.4f} -> {losses[-1]:.4f}",
              flush=True)
        print(f"checkpoints in {args.ckpt}: "
              f"{sorted(os.listdir(args.ckpt))[-1]}", flush=True)
    return losses


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
