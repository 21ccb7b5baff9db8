"""Device meshes over {data, model} (port of ggmlsharp_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")`` over the ranks of the initialized process group
(``parallel.distributed.initialize``): ``mesh["model"].get_group()`` is the
tensor-parallel group, and ``mesh.shape`` reads as in the JAX package
(``mesh_shape(mesh)`` gives the dict form). The ``model`` dim holds
neighbouring ranks (the tensor-parallel collectives), ``data`` the rest.
"""
from __future__ import annotations

import os

import torch.distributed as dist


def _world():
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a process group: call "
            "parallel.distributed.initialize() (or init_process_group) first")
    return dist.get_world_size()


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(data: int | None = None, model: int | None = None,
              devices=None, device_type: str | None = None):
    """A ("data", "model") DeviceMesh. The JAX defaults: every rank on
    ``model`` (data 1); given one of the two, the other is world // it.
    ``devices``: the global ranks to use (default all; data * model of
    them). device_type: the mesh's device type (default "cuda" for an NCCL
    world, "cpu" for a gloo one)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices) if devices is not None else list(range(_world()))
    n = len(ranks)
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model > n or data * model < 1:
        raise ValueError(f"mesh data={data} x model={model} does not fit "
                         f"{n} ranks")
    import torch

    grid = torch.tensor(ranks[:data * model]).reshape(data, model)
    return DeviceMesh(_device_type(device_type), grid,
                      mesh_dim_names=("data", "model"))


def make_hybrid_mesh(model_per_host: int | None = None,
                     device_type: str | None = None):
    """The {data, model} mesh with ``model`` over the ranks of one node
    (torchrun's LOCAL_WORLD_SIZE; all ranks without it) and ``data`` across
    nodes. Without ICI this is all the JAX function's hybrid layout means."""
    n = _world()
    model = model_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return make_mesh(model=model, device_type=device_type)


def make_axis_mesh(name: str, n: int | None = None,
                   device_type: str | None = None):
    """A one-dimensional mesh named ``name`` over the first n ranks (all by
    default): the pipe mesh of ``llama.forward_pp``, a sequence mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch

    n = n or _world()
    return DeviceMesh(_device_type(device_type), torch.arange(n),
                      mesh_dim_names=(name,))


def mesh_shape(mesh) -> dict:
    """{dim name: size}, the JAX Mesh.shape form."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
