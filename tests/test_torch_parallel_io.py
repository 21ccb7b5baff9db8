"""The port's sharding rules, the sharded checkpoint pair, the
CheckpointedLoop, bring-up, the dry run and the distributed training
example, on the CPU.

  * shard_params' fused-weight rule (rank r's own heads of q, k and v,
    its own rows of gate and up) against the JAX package's meaning of the
    same weights, and the ValueErrors for shards that do not divide;
  * save_checkpoint_sharded / load_checkpoint_sharded over a 2-rank gloo
    world (tests/_torch_parallel_ranks.ckpt): into the ranks' own shards
    (``like``) and whole, bit for bit; a JAX orbax checkpoint refused;
  * CheckpointedLoop resume (npz in one process, sharded in the world), as
    tests/test_parallel.py::test_checkpointed_loop_resume;
  * initialize() a no-op in a world of one, dryrun.run(4) and
    examples/train_distributed_torch.py in spawned gloo worlds; the entry
    points refuse the CPU unless asked.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.io import checkpoint as ck
from ggmlsharp_tpu_torch.models import gpt2, llama
from ggmlsharp_tpu_torch.models.common import local_count
from ggmlsharp_tpu_torch.parallel import comm, distributed, dryrun, sharding
from ggmlsharp_tpu_torch.quant.formats import QTensor, split_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _axis(rank, size):
    return comm.Axis(None, rank, size, "gloo")


def _rows_equal(a, b):
    if isinstance(a, QTensor):
        assert isinstance(b, QTensor) and a.gtype == b.gtype \
            and a.shape == b.shape, (a, b)
        for k in a.planes:
            assert torch.equal(a.planes[k], b.planes[k]), k
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("quant", [False, True])
def test_fused_weight_shard_is_each_parts_own_rows(quant):
    """wqkv = [q; k; v] shards as [q_r; k_r; v_r]: rank r's heads of each,
    the rows JAX's unfused tree gives rank r's heads (wq rows r·nq/D...)."""
    cfg = llama.LlamaConfig(n_vocab=256, n_ctx=32, n_embd=256, n_head=8,
                            n_head_kv=4, n_layer=1, n_ff=512)
    jraw = jllama.init_params(jax.random.PRNGKey(2), jllama.LlamaConfig(
        **{k: getattr(cfg, k) for k in ("n_vocab", "n_ctx", "n_embd",
                                        "n_head", "n_head_kv", "n_layer",
                                        "n_ff")}), dtype=jnp.float32)
    raw = llama.params_from_jax(
        jax.tree.map(np.asarray, jraw), device="cpu")
    tree = llama.quantize_params(raw, GType.Q4_0) if quant \
        else llama.fuse_params(raw)
    blk = tree["blocks"][0]
    nq, nkv = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
    wq, wk, wv = split_rows(blk["wqkv"], (nq, nkv, nkv))
    gate, up = split_rows(blk["w_gate_up"], (cfg.n_ff, cfg.n_ff))
    spec = sharding.llama_param_specs()["blocks"]
    for D in (2, 4):
        for r in range(D):
            got = sharding.shard_leaf(blk["wqkv"], spec["wqkv"], r, D,
                                      "wqkv", blk)
            parts = [sharding._take_rows(t, r * t.shape[0] // D,
                                         t.shape[0] // D)
                     for t in (wq, wk, wv)]
            _rows_equal(got, sharding._cat_rows(parts))
            got = sharding.shard_leaf(blk["w_gate_up"], spec["w_gate_up"],
                                      r, D, "w_gate_up", blk)
            _rows_equal(got, sharding._cat_rows(
                [sharding._take_rows(t, r * cfg.n_ff // D, cfg.n_ff // D)
                 for t in (gate, up)]))
            # the local forward splits a shard as the whole model splits
            # the whole weight: its q rows are rank r's heads of wq
            lq = split_rows(sharding.shard_leaf(
                blk["wqkv"], spec["wqkv"], r, D, "wqkv", blk),
                (nq // D, nkv // D, nkv // D))[0]
            _rows_equal(lq, sharding._take_rows(wq, r * nq // D, nq // D))


def test_gpt2_thirds_and_vocab_padding():
    cfg = gpt2.GPT2Config(n_vocab=101, n_ctx=16, n_embd=64, n_head=4,
                          n_layer=1)
    p = gpt2.init_params(cfg, device="cpu", dtype=torch.float32)
    attn = p["blocks"][0]["attn"]
    spec = sharding.gpt2_param_specs()
    E = cfg.n_embd
    for r in range(2):
        w = sharding.shard_leaf(attn["c_attn_w"],
                                spec["blocks"]["attn"]["c_attn_w"], r, 2,
                                "c_attn_w", attn)
        want = torch.cat([attn["c_attn_w"][j * E + r * E // 2:
                                           j * E + (r + 1) * E // 2]
                          for j in range(3)])
        assert torch.equal(w, want)
        b = sharding.shard_leaf(attn["c_attn_b"],
                                spec["blocks"]["attn"]["c_attn_b"], r, 2,
                                "c_attn_b", attn)
        assert torch.equal(b, torch.cat([attn["c_attn_b"][
            j * E + r * E // 2:j * E + (r + 1) * E // 2] for j in range(3)]))
        wte = sharding.shard_leaf(p["wte"], spec["wte"], r, 2, "wte", p)
        assert wte.shape == (51, E)  # 101 rows padded to 102
    assert torch.equal(sharding.shard_leaf(p["wte"], spec["wte"], 1, 2,
                                           "wte", p)[-1], torch.zeros(E))


def test_shards_that_do_not_divide_raise():
    # Llama-7B's w_down in Q4_K at model 2: K/2 = 5504 is not whole 256-blocks
    w = quantize(torch.randn(2, 11008), GType.Q4_K)
    with pytest.raises(ValueError, match=r"w_down.*5504.*Q4_K.*256"):
        sharding.row_shard(w, 0, 2, "w_down")
    # Q4_0's 32-element blocks divide
    q = sharding.row_shard(quantize(torch.randn(2, 11008), GType.Q4_0), 1,
                           2, "w_down")
    assert q.shape == (2, 5504) and q.planes["qs"].shape == (2, 2752)
    with pytest.raises(ValueError, match="n_head_kv = 2 .* model axis of 4"):
        local_count(2, _axis(0, 4), "n_head_kv")
    with pytest.raises(ValueError, match="wq: 96 rows"):
        sharding.col_shard(torch.zeros(96, 8), sharding.COL, 0, 5, "wq")
    with pytest.raises(ValueError, match="c_proj_w: 10 columns"):
        sharding.row_shard(torch.zeros(4, 10), 0, 4, "c_proj_w")


def test_sharded_tree_passes_tree_walkers():
    """The "tp" entry holds no leaves and survives tree_map/unflatten."""
    from ggmlsharp_tpu_torch.optim.tree import (tree_leaves, tree_map,
                                                tree_unflatten)

    shd = sharding.Sharding(_axis(0, 2), None, {}, {})
    tree = {"a": torch.ones(2), "tp": shd, "b": [torch.zeros(1)]}
    assert len(tree_leaves(tree)) == 2
    assert tree_map(lambda t: t + 1, tree)["tp"] is shd
    assert tree_unflatten(tree, [torch.ones(2), torch.ones(1)])["tp"] is shd


@pytest.fixture(scope="module")
def ck_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ckpt"))
    distributed.spawn(ranks.ckpt, 2, args=(out,), threads=1,
                      init_file=f"{out}/store")
    return [(torch.load(f"{out}/ckpt_{r}.pt", weights_only=False),
             torch.load(f"{out}/loop_{r}.pt", weights_only=False))
            for r in range(2)]


def _walk_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) - {"tp"} == set(b) - {"tp"}, path
        for k in a:
            if k != "tp":
                _walk_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk_equal(x, y, f"{path}/{i}")
    elif a is None:
        assert b is None, path
    else:
        _rows_equal(a, b)


def test_sharded_checkpoint_restores_each_ranks_shards(ck_world):
    for res, _ in ck_world:
        _walk_equal(res["shard"], res["got"])
        assert res["steps"] == (7, 7) and res["got_tp"]


def test_sharded_checkpoint_restores_whole_without_like(ck_world):
    """Restored whole: the logical tree, the vocabulary padding cut and the
    fused weights' parts back in [q; k; v] order."""
    for res, _ in ck_world:
        _walk_equal(res["full"], res["whole"])
        assert res["whole"]["tok_embd"].shape == (512, 256)  # 300 -> 512


def test_sharded_tree_refuses_the_flat_cache(ck_world):
    assert all(res["flat_refused"] for res, _ in ck_world)


def test_checkpointed_loop_resumes_sharded(ck_world):
    for _, loop in ck_world:
        assert loop["sharded"] and loop["resumed"] == 5
        assert torch.equal(loop["s2"], loop["s1"])
        assert torch.equal(loop["s3"], loop["s1"] + 3.0)
        assert loop["step"] == 8 and loop["wq_equal"]


def test_orbax_checkpoint_is_refused(tmp_path):
    d = tmp_path / "orbax_ck"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps({"meta": {}, "step": 1,
                                             "orbax": True}))
    with pytest.raises(ValueError, match="orbax"):
        ck.load_checkpoint_sharded(str(d), device="cpu")
    np.savez(d / "arrays.npz", w=np.zeros(2))
    (d / "meta.json").write_text(json.dumps({"meta": {}, "step": 1}))
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        ck.load_checkpoint_sharded(str(d), device="cpu")


def test_sharded_checkpoint_one_process_round_trip(tmp_path):
    """Without a process group every leaf is replicated: a plain tree, a
    QTensor and a None go through DCP bit for bit."""
    tree = {"w": torch.randn(4, 8), "q": quantize(torch.randn(2, 256),
                                                  GType.Q4_0),
            "blocks": [{"g": torch.ones(3, dtype=torch.bfloat16)}],
            "none": None}
    ck.save_checkpoint_sharded(str(tmp_path / "c"), tree, step=3)
    got, step = ck.load_checkpoint_sharded(str(tmp_path / "c"), device="cpu")
    assert step == 3
    _walk_equal(tree, got)


def test_checkpointed_loop_resume_one_process(tmp_path):
    from ggmlsharp_tpu_torch.parallel.distributed import CheckpointedLoop

    def step_fn(state, step):
        return {k: v + 1.0 for k, v in state.items()}

    d = str(tmp_path / "ck")
    loop = CheckpointedLoop(step_fn, d, every=5, device="cpu")
    assert not loop.sharded
    state = loop.run(loop.resume({"w": torch.zeros(3)}), 12)
    assert float(state["w"][0]) == 12.0
    loop2 = CheckpointedLoop(step_fn, d, every=5, device="cpu")
    state2 = loop2.resume({"w": torch.zeros(3)})
    assert loop2.step == 12 and float(state2["w"][0]) == 12.0
    assert float(loop2.run(state2, 3)["w"][0]) == 15.0
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000010",
                                     "step_00000012", "step_00000015"]


def test_checkpointed_loop_raises_restart_needed(tmp_path):
    import torch.distributed as dist

    def step_fn(state, step):
        if step == 3:
            raise dist.DistBackendError("peer lost")
        return state

    loop = distributed.CheckpointedLoop(step_fn, str(tmp_path / "ck"),
                                        every=2, device="cpu")
    with pytest.raises(distributed.RestartNeeded) as e:
        loop.run({"w": torch.zeros(1)}, 10)
    assert e.value.step == 3 and e.value.checkpoint_path.endswith(
        "step_00000002")


def test_cut_sharded_save_is_skipped(tmp_path, monkeypatch):
    """A sharded save cut short (half its arrays written, then the runtime
    error) leaves no meta.json: the restart names the last whole
    checkpoint, and resume loads that one."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    save = dcp.save

    def cut(state, checkpoint_id):
        if checkpoint_id.split(os.sep)[-2] == "step_00000004":
            save(dict(list(state.items())[:1]), checkpoint_id=checkpoint_id)
            raise dist.DistBackendError("peer lost while saving")
        save(state, checkpoint_id=checkpoint_id)

    def step_fn(state, step):
        return {k: v + 1.0 for k, v in state.items()}

    def fresh():
        loop = distributed.CheckpointedLoop(step_fn, d, every=2,
                                            device="cpu")
        loop.sharded = True  # the multi-rank world's checkpoints
        return loop

    d = str(tmp_path / "ck")
    monkeypatch.setattr(dcp, "save", cut)
    init = {"w": torch.zeros(3), "b": torch.ones(2)}
    with pytest.raises(distributed.RestartNeeded) as e:
        fresh().run(init, 6)
    assert e.value.step == 4 and e.value.checkpoint_path.endswith(
        "step_00000002")
    cut_dir = os.path.join(d, "step_00000004")
    assert os.path.isdir(os.path.join(cut_dir, "arrays"))
    assert not os.path.exists(os.path.join(cut_dir, "meta.json"))
    monkeypatch.setattr(dcp, "save", save)
    loop = fresh()
    state = loop.resume(init)
    assert loop.step == 2 and torch.equal(state["w"], torch.full((3,), 2.0))
    assert torch.equal(state["b"], torch.full((2,), 3.0))


def test_initialize_is_a_noop_in_a_world_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1, device="cpu") is False


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ex = _example()
    for call in (lambda: dryrun.run(4),
                 lambda: distributed.initialize(num_processes=2),
                 lambda: ex.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_isolation_scan_covers_the_parallel_slice():
    import test_torch_isolation as iso

    rel = {os.path.relpath(p, ROOT) for p in iso._port_files()}
    assert {f"ggmlsharp_tpu_torch/parallel/{m}.py" for m in (
        "mesh", "comm", "sharding", "overlap", "pipeline", "ring_attention",
        "distributed", "dryrun")} | {"examples/train_distributed_torch.py"} \
        <= rel


def test_dryrun_four_ranks():
    dryrun.run(4, device="cpu")


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_distributed_torch",
        os.path.join(ROOT, "examples", "train_distributed_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_distributed_example_resumes(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ex = _example()
    d = str(tmp_path / "ck")
    argv = ["--world", "4", "--data", "2", "--device", "cpu", "--ckpt", d]
    assert ex.main(argv + ["--steps", "12"]) == 0
    assert sorted(os.listdir(d)) == ["step_00000010", "step_00000012"]
    assert ex.main(argv + ["--steps", "3"]) == 0  # resumes at 12
    assert sorted(os.listdir(d))[-1] == "step_00000015"
