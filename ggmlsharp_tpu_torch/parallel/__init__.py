"""Scale-out over torch.distributed (port of ggmlsharp_tpu/parallel).

The JAX package annotates shardings and lets GSPMD insert the collectives;
GSPMD has no PyTorch counterpart that reaches the port's hand-written
kernels (ctypes launches on plain tensors). So the port follows the
Megatron pattern: SPMD with one controller a rank, every rank holding its
local shard as a plain tensor or QTensor, and the models issuing the
collectives (``comm``) that GSPMD would insert, which are identities when
no mesh is installed. DTensor appears only at the checkpoint boundary
(``io.save_checkpoint_sharded``).

  * ``mesh``: the ("data", "model") DeviceMesh;
  * ``comm``: the collectives, gloo's host staging of CUDA tensors, and
    the autograd pair for training;
  * ``sharding``: the spec trees, ``shard_params`` and ``shard_cache``;
  * ``pipeline``: GPipe forward and the 1F1B training step;
  * ``ring_attention``: sequence-parallel attention (GGML_TPU_ATTN=ring);
  * ``overlap``: the row-parallel matmul with its ring overlapped;
  * ``distributed``: bring-up, ``CheckpointedLoop``, ``spawn``;
  * ``dryrun``: every path above on a small world.
"""

from .mesh import make_hybrid_mesh, make_mesh, mesh_shape
from .pipeline import pipeline_forward, pipeline_train_step
from .ring_attention import ring_attention, sequence_mesh, set_sequence_mesh
from .sharding import (COL, REP, ROW, VOCAB, gpt2_param_specs, kv_cache_spec,
                       llama_param_specs, shard_cache, shard_params,
                       shard_qtensor_spec)

__all__ = [
    "COL",
    "REP",
    "ROW",
    "VOCAB",
    "gpt2_param_specs",
    "kv_cache_spec",
    "llama_param_specs",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_shape",
    "pipeline_forward",
    "pipeline_train_step",
    "ring_attention",
    "sequence_mesh",
    "set_sequence_mesh",
    "shard_cache",
    "shard_params",
    "shard_qtensor_spec",
]
