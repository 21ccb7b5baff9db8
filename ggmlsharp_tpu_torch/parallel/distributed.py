"""Bring-up and recovery for many processes (port of
ggmlsharp_tpu/parallel/distributed.py).

  * ``initialize()``: ``torch.distributed.init_process_group`` from
    torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (or
    arguments); a no-op in a world of one. The backend is chosen by name:
    NCCL for the card, gloo for the CPU, unless the caller names one. The
    group takes a finite timeout, so a lost peer raises instead of hanging.
  * ``barrier()``: every rank waits for all.
  * ``CheckpointedLoop``: run a step function with periodic checkpoints;
    on an error of the distributed runtime (a collective timeout, a lost
    peer) raise ``RestartNeeded`` carrying the newest checkpoint, for a
    supervisor to relaunch and ``resume()``.
  * ``spawn(fn, world, ...)``: a world of ``world`` processes on this
    host (torch.multiprocessing, the spawn start method), fn(rank, *args)
    in each after its process group is up; a failed rank fails the call.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 300


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """init_process_group from the arguments or torchrun's variables
    (coordinator_address "host:port" or MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE, RANK). Returns False, doing nothing, in a world of one.
    backend None: "nccl" when ``device`` (default the card) is CUDA, else
    "gloo"; with NCCL the rank's card is LOCAL_RANK's."""
    n = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return False
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", "0"))
    addr = coordinator_address or (
        f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
        f"{os.environ.get('MASTER_PORT', '29500')}")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def barrier(mesh=None):
    """Every rank of the world waits for all (a no-op without a process
    group)."""
    if dist.is_initialized():
        dist.barrier()


class RestartNeeded(RuntimeError):
    def __init__(self, checkpoint_path: str | None, step: int,
                 cause: Exception):
        super().__init__(
            f"restart from {checkpoint_path} @ step {step}: {cause}")
        self.checkpoint_path = checkpoint_path
        self.step = step
        self.cause = cause


# what a lost peer or a collective timeout raises
RUNTIME_ERRORS = (dist.DistError, TimeoutError)


class CheckpointedLoop:
    """Run ``step_fn(state, step) -> state`` with a checkpoint every
    ``every`` steps (and at the end) into ``ckpt_dir/step_%08d``; on an
    error of the distributed runtime raise RestartNeeded with the newest
    checkpoint.

    The checkpoints are sharded (``io.save_checkpoint_sharded``, each rank
    writing its shards) when a process group of more than one rank is up,
    or the state is a sharded tree (a world of one included: its ``"tp"``
    entry holds process groups, which no npz can hold), the npz ones
    otherwise. ``resume(init_state)`` loads the
    newest checkpoint into init_state's layout (a sharded tree restores
    into its own shards; any other onto ``device``, the card by default);
    ``resume(init_state, in_place=True)`` copies it into init_state's own
    tensors and returns init_state, so a captured step whose graph reads
    those tensors (examples/train_distributed_torch.py) goes on reading
    them.
    A step directory without its ``meta.json`` (a save cut short) is
    skipped.

        loop = CheckpointedLoop(step_fn, ckpt_dir, every=100)
        state = loop.resume(init_state)
        state = loop.run(state, n_steps)
    """

    def __init__(self, step_fn, ckpt_dir: str, every: int = 100,
                 device=None):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.step = 0
        self._saved = None  # the step of the newest checkpoint written
        self.sharded = dist.is_initialized() and dist.get_world_size() > 1
        self.device = device

    def _ckpt_path(self):
        return os.path.join(self.ckpt_dir, f"step_{self.step:08d}")

    def _latest(self):
        if not os.path.isdir(self.ckpt_dir):
            return None
        entries = sorted(e for e in os.listdir(self.ckpt_dir)
                         if e.startswith("step_")
                         and os.path.exists(os.path.join(
                             self.ckpt_dir, e, "meta.json")))
        return os.path.join(self.ckpt_dir, entries[-1]) if entries else None

    def _sharded(self, tree) -> bool:
        return self.sharded or (isinstance(tree, dict)
                                and tree.get("tp") is not None)

    def _save(self, state):
        from ..io import checkpoint as ck

        if self._sharded(state):
            ck.save_checkpoint_sharded(self._ckpt_path(), state,
                                       step=self.step)
        else:
            ck.save_checkpoint(self._ckpt_path(), state, step=self.step)
        self._saved = self.step

    def resume(self, init_state, in_place: bool = False):
        from ..io import checkpoint as ck
        from ..optim.tree import tree_leaves

        latest = self._latest()
        if latest is None:
            return init_state
        if self._sharded(init_state):
            state, step = ck.load_checkpoint_sharded(latest, like=init_state,
                                                     device=self.device)
        else:
            state, step = ck.load_checkpoint(latest, device=self.device)
        self.step = step or 0
        self._saved = self.step
        if not in_place:
            return state
        with torch.no_grad():
            for dst, src in zip(tree_leaves(init_state), tree_leaves(state),
                                strict=True):
                planes = getattr(dst, "planes", None)
                pairs = [(planes[k], src.planes[k]) for k in planes] \
                    if isinstance(planes, dict) else [(dst, src)]
                for d, v in pairs:
                    d.copy_(v)
        return init_state

    def run(self, state, n_steps: int):
        target = self.step + n_steps
        try:
            while self.step < target:
                state = self.step_fn(state, self.step)
                self.step += 1
                if self.every and self.step % self.every == 0:
                    self._save(state)
            if self._saved != self.step:
                self._save(state)
        except RUNTIME_ERRORS as e:
            raise RestartNeeded(self._latest(), self.step, e) from e
        return state


def _rank_main(rank, fn, world, init_file, backend, device, timeout_s,
               threads, args):
    if threads:
        torch.set_num_threads(threads)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), backend: str = "gloo",
          init_file: str | None = None, device=None,
          timeout_s: float = DEFAULT_TIMEOUT_S, threads: int | None = None):
    """Run fn(rank, *args) in ``world`` new processes (spawn start method)
    joined by a process group of ``backend`` over a FileStore at
    ``init_file`` (a fresh temporary file by default). device: a CUDA
    device every rank computes on (torch.cuda.set_device), e.g. "cuda:0"
    for several ranks on one card over gloo. threads: torch's intra-op
    threads a rank. Any rank's exception fails the call (ProcessRaisedException);
    the process group's timeout bounds every collective. fn must be
    importable by name (a module-level function)."""
    import tempfile

    import torch.multiprocessing as mp

    cleanup = None
    if init_file is None:
        fd, init_file = tempfile.mkstemp(prefix="ggml_world_")
        os.close(fd)
        os.unlink(init_file)
        cleanup = init_file
    try:
        mp.spawn(_rank_main, args=(fn, world, init_file, backend, device,
                                   timeout_s, threads, tuple(args)),
                 nprocs=world, join=True)
    finally:
        if cleanup and os.path.exists(cleanup):
            os.unlink(cleanup)
