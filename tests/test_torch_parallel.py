"""Tensor parallelism over kv heads (``xkv_tpu_torch/parallel/``, the
engine's ``mesh``) on the CPU.

Two gloo processes on 127.0.0.1 (``tests/_torch_ranks.py``) serve
``tiny_llama_config`` (4 layers in one xKV-4 group, 4 q / 2 kv heads, fp32
weights and cache) at a model axis of 2 beside the unsharded port engine in the same process (which
``tests/test_torch_engine.py`` holds against the JAX engine), in pre and
post, bf16 and int8 factors, and in fp32 factors, fake and none, with
``tail_max`` 4 so that ``generate`` (10 tokens) folds its tail twice. No
JAX mesh engine runs here: the JAX mesh engines compile slowly and their
tests are ``slow`` (``tests/test_sharding.py``). The weight shards are held
against the JAX package's ``shard_params`` on the 8-device virtual CPU
mesh (``tests/conftest.py``; a ``device_put``, nothing compiled).

Tolerances:
  * tokens equal to the unsharded engine's, in every run;
  * prefill logits within 1e-5, and each decode step's (the first, and the
    first after a refold) within 1e-5 of the unsharded step over the same
    factors: the sharded cache joined from both ranks (``gather_cache``).
    The sharded model sums each ``wo`` / ``w_down`` product in two halves,
    so its fp32 activations differ from one device's by ~1e-7;
  * the same steps against the unsharded engine's own cache: the first
    step within 1e-5 in every run (readings <= 1.4e-6), the first after a
    refold within 1e-5 with fp32 factors. With bf16 or int8 factors the
    ~1e-7 differences of the SVD's input move single factor elements by one
    unit of their rounding (bf16: 2^-8 of the value), and the refold's SVD
    runs over matrices rebuilt from those rounded factors: the logits after
    the refold moved by 6.0e-4 (bf16, pre) and 1.6e-4 (int8, post) in these
    runs, and the limits are twice those readings (``TOL_REFOLD``).
"""

import dataclasses
import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xkv_tpu.parallel.sharding import shard_params as jax_shard_params
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.parallel import distributed
from xkv_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from xkv_tpu_torch.parallel.sharding import param_pspecs, shard_params

TOL = 1e-5
# After a refold, against the unsharded engine's own cache, by factor
# dtype (twice the readings: module docstring).
TOL_REFOLD = {"bf16": 2 * 6.0e-4, "int8": 2 * 1.6e-4}
RUNS = {  # label: (mode, rope_mode, factor dtype)
    "pre bf16": ("factored", "pre", "bf16"), "pre int8": ("factored", "pre", "int8"),
    "post bf16": ("factored", "post", "bf16"), "post int8": ("factored", "post", "int8"),
    "pre fp32": ("factored", "pre", "fp32"), "fake bf16": ("fake", "pre", "bf16"),
    "none": ("none", "pre", "bf16"),
}


RANK = textwrap.dedent("""
    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.models.llama import init_params
    from xkv_tpu_torch.parallel.distributed import allgather_obj, init_distributed
    from xkv_tpu_torch.parallel.mesh import make_mesh
    from xkv_tpu_torch.parallel.sharding import gather_cache

    runs = json.loads(argv[0])
    dc = init_distributed("gloo")  # the group run_ranks joined
    mesh = make_mesh(data=1, model=2)
    cfg = tiny_llama_config(num_layers=4, num_q_heads=4, num_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(1))
    dtypes = {"bf16": torch.bfloat16, "int8": "int8", "fp32": torch.float32}
    res = {"dist": [dc.rank, dc.world_size, dc.backend, mesh.model_rank],
           "gathered": allgather_obj({"rank": rank, "t": (rank, 1.5)})}

    def diff(a, b):
        return (a - b).abs().max().item()

    for label, (mode, rope, fd) in runs.items():
        xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=4,
                                              rank_k=16, rank_v=16,
                                              extra_kwargs={"rope_mode": rope})
        kw = dict(xkv=None if mode == "none" else xkv, mode=mode, tail_max=4,
                  cache_dtype=torch.float32, factor_dtype=dtypes[fd], device="cpu")
        one = InferenceEngine(params, cfg, **kw)
        tp = InferenceEngine(params, cfg, mesh=mesh, **kw)
        n_new = 10 if mode == "factored" else 4  # refolds in factored mode only
        row = {"tokens": tp.generate(prompt, n_new).tolist(),
               "tokens_one": one.generate(prompt, n_new).tolist()}
        lo, co = one.prefill(prompt)
        lt, ct = tp.prefill(prompt)
        row["prefill"] = diff(lo, lt)
        toks = row["tokens_one"][0]
        steps = ("first", "refold") if mode == "factored" else ("first",)
        pos = prompt.shape[1]
        for name in steps:
            i0 = 4 if name == "refold" else 0
            if name == "refold":
                for i in range(1, 5):  # a full tail, then the fold
                    t = torch.tensor([[toks[i - 1]]])
                    _, co = one.decode_step(co, t, pos + i - 1)
                    _, ct = tp.decode_step(ct, t, pos + i - 1)
                co, ct = one.refactorize(co), tp.refactorize(ct)
            # One step from each cache (each call returns an advanced copy and
            # leaves co / ct where they stand).
            t = torch.tensor([[toks[i0]]])
            joined = gather_cache(ct, [4] * len(ct.groups), mesh)
            s_one, _ = one.decode_step(co, t, pos + i0)
            s_join, _ = one.decode_step(joined, t, pos + i0)
            s_tp, _ = tp.decode_step(ct, t, pos + i0)
            row[name] = [diff(s_tp, s_join), diff(s_tp, s_one)]
            vt = ct.groups[0].k_vt if ct.groups else None
            row["shard_heads"] = [ct.tail_k.shape[2], None if vt is None else vt.shape[-1]]
        res[label] = row
    finish(res)
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(RANK, 2, str(tmp_path_factory.mktemp("tp")), json.dumps(RUNS))


def test_distributed_over_two_gloo_processes(two_ranks):
    assert two_ranks["dist"] == [0, 2, "gloo", 0]
    # by rank, each through JSON (the tuple comes back a list), as JAX's
    assert two_ranks["gathered"] == [{"rank": 0, "t": [0, 1.5]}, {"rank": 1, "t": [1, 1.5]}]


@pytest.mark.parametrize("label", list(RUNS))
def test_tp_engine_matches_one_device(two_ranks, label):
    row = two_ranks[label]
    mode, _, fd = RUNS[label]
    assert len(row["tokens"][0]) == (10 if mode == "factored" else 4)
    assert row["tokens"] == row["tokens_one"]
    assert row["prefill"] <= TOL
    steps = ("first", "refold") if mode == "factored" else ("first",)
    for name in steps:
        joined, one = row[name]
        assert joined <= TOL, (name, joined)
        own = TOL_REFOLD[fd] if name == "refold" and fd != "fp32" else TOL
        assert one <= own, (name, one)
    # a rank holds 1 of 2 kv heads: its tail, and 4 layers x 1 head x 16 columns
    assert row["shard_heads"][0] == 1
    if mode == "factored":
        assert row["shard_heads"][1] == 4 * 1 * 16


def test_init_distributed_in_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    dc = distributed.init_distributed("gloo")
    assert (dc.rank, dc.world_size, dc.backend, dc.is_main) == (0, 1, None, True)
    assert distributed.allgather_obj({"a": (1, 2)}) == [{"a": (1, 2)}]
    distributed.barrier()
    with pytest.raises(ValueError, match="backend"):
        distributed.init_distributed("mpi")
    mesh = make_mesh()
    assert (mesh.shape, mesh.model_rank, mesh.group) == ({"data": 1, "model": 1}, 0, None)
    assert single_device_mesh() == mesh
    with pytest.raises(ValueError, match="mesh 1x2 != 1 ranks"):
        make_mesh(data=1, model=2)


def test_a_data_axis_is_refused(monkeypatch):
    """A data axis is served (``tests/test_torch_parallel_data.py`` runs it
    over gloo): ``make_mesh`` places rank r at (r // model, r % model) and
    builds a model group per data row and a data group per model column,
    every group on every rank in the same order. What a data axis refuses:
    a batch that does not divide it, and a mesh with a data axis but no
    groups (one made by hand)."""
    from xkv_tpu_torch.parallel import mesh as mesh_mod

    made = []
    monkeypatch.setattr(mesh_mod, "_world", lambda: (4, 3))  # a world of 4, rank 3
    monkeypatch.setattr(mesh_mod.dist, "new_group", lambda ranks: made.append(ranks) or ranks)
    mesh = make_mesh(data=2, model=2)
    assert made == [[0, 1], [2, 3], [0, 2], [1, 3]]
    assert (mesh.data_rank, mesh.model_rank, mesh.model_src) == (1, 1, 2)
    assert (mesh.group, mesh.data_group) == ([2, 3], [1, 3])
    made.clear()
    mesh = make_mesh(model=1)  # data=None takes the 4 ranks
    assert made == [[0], [1], [2], [3], [0, 1, 2, 3]]
    assert (mesh.shape, mesh.data_rank, mesh.group) == ({"data": 4, "model": 1}, 3, None)
    x = torch.arange(8).reshape(8, 1)
    assert mesh.rows(x).tolist() == [[6], [7]]
    with pytest.raises(ValueError, match="6 rows does not split over a data axis of 4"):
        mesh.rows(x[:6])
    with pytest.raises(ValueError, match="needs its groups"):
        Mesh(data=2, model=2, rank=0).group
    mesh = Mesh(data=1, model=2, rank=1)  # one data row: the default group
    assert (mesh.model_rank, mesh.data_rank, mesh.shape) == (1, 0, {"data": 1, "model": 2})


def test_shards_match_jax_shard_params():
    """Each rank's slices against the matching shard of the JAX package's
    ``shard_params`` on a (data 1, model 2) mesh of the virtual CPU devices;
    attention biases and untied embeddings included."""
    jcfg = jax_tiny(num_layers=2, num_q_heads=4, num_kv_heads=2, attention_bias=True)
    jparams = jax_init(jcfg, jax.random.PRNGKey(3))
    sharded = jax_shard_params(jparams, jax_make_mesh(data=1, model=2,
                                                      devices=jax.devices()[:2]))
    np_params = jax.tree.map(np.asarray, jparams)
    for r in range(2):
        mine = shard_params(params_from_numpy(np_params, device="cpu"),
                            Mesh(data=1, model=2, rank=r))
        flat_j = jax.tree_util.tree_flatten_with_path(sharded)[0]
        for path, arr in flat_j:
            node = mine
            for key in path:
                node = node[getattr(key, "key", getattr(key, "idx", None))]
            shard = next(s for s in arr.addressable_shards if s.device == jax.devices()[r])
            want = np.asarray(shard.data)
            got = node.float().numpy() if node.dtype == torch.bfloat16 else node.numpy()
            assert got.shape == want.shape, path
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=str(path))
    specs = param_pspecs(params_from_numpy(np_params, device="cpu"))
    assert specs["lm_head"] == 1 and specs["embed"] is None
    assert specs["layers"][0]["attn"] == {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0,
                                          "bk": 0, "bv": 0}
    assert specs["layers"][0]["mlp"] == {"w_gate": 1, "w_up": 1, "w_down": 0}


MESH2 = Mesh(data=1, model=2, rank=0)
MLA_CFG = tiny_llama_config(num_layers=4, model_type="deepseek_v2", kv_lora_rank=16,
                            qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16)


def _engine(**kw):
    cfg = kw.pop("cfg", tiny_llama_config(num_layers=4))
    xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=2,
                                          rank_k=16, rank_v=16,
                                          extra_kwargs=kw.pop("extra", None))
    model = deepseek if cfg.model_type == "deepseek_v2" else llama
    params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    return InferenceEngine(params, cfg, xkv=kw.pop("xkv", xkv), device="cpu", mesh=MESH2, **kw)


# (engine options, the refusal's message, or None where the engine serves it)
SCOPE = [
    (dict(sparse_topk=2, sparse_block=8), None),
    (dict(factor_dtype="int4", extra={"rope_mode": "post"}), None),
    (dict(staged_prefill=True, prefill_logits="last"), "staged_prefill is single-device"),
    (dict(sparse_topk=2, sparse_topk_max=4, sparse_block=8), "sparse_topk_max is single-device"),
    (dict(xkv=generate_consecutive_xkv_config(
        layer_merge_impl="slerp", num_layers=4, end_layer=-1, group_size=2, rank_k=None,
        rank_v=None)), "slerp"),
    (dict(sequence_parallel=True), None),
    (dict(cfg=MLA_CFG, xkv=None, mode="none"), None),
    (dict(cfg=tiny_llama_config(num_layers=4, num_q_heads=3, num_kv_heads=1)), "split"),
    (dict(cfg=dataclasses.replace(MLA_CFG, num_q_heads=3), xkv=None, mode="none"), "3 q heads"),
]


@pytest.mark.parametrize("kw,msg", SCOPE, ids=["sparse", "int4", "staged", "sparse_topk_max",
                                               "slerp", "sequence_parallel", "mla", "heads",
                                               "mla_heads"])
def test_out_of_scope_tp_is_refused(kw, msg):
    """Under a model axis of 2: sparse top-k, int4 factors, MLA and
    sequence parallelism (a ring of one data rank; its decode holds the
    data rows as replicas) are served (a rank's share of the heads and
    experts); staged prefill and ``sparse_topk_max`` are refused with the
    JAX engine's reasons, the slerp scheme naming ROADMAP item 17, heads
    that do not split by the count."""
    if msg is None:
        eng = _engine(**kw)
        sp = kw.get("sequence_parallel", False)
        assert eng.mesh == dataclasses.replace(MESH2, replicas=sp)
        assert eng.mesh is MESH2 or sp
        assert eng.shard_cfg.num_q_heads == eng.cfg.num_q_heads // 2
        return
    with pytest.raises(ValueError, match=msg) as err:
        _engine(**kw)
    if msg == "slerp":
        assert "ROADMAP item 17" in str(err.value)


def test_graphs_and_batching_refuse_a_mesh():
    """The captured steps refuse a mesh (gloo's collectives cannot be
    captured); ``BatchedEngine`` under a mesh builds and steps eagerly."""
    from xkv_tpu_torch.engine.graphs import (BatchedSpecRound, BatchedStep, DecodeGraph,
                                             SpecRounds)

    class Eng:
        mesh = MESH2

    with pytest.raises(ValueError, match="ROADMAP item 17"):
        DecodeGraph(Eng(), None, 0, 1, first_token=torch.zeros(1, 1))
    with pytest.raises(ValueError, match="ROADMAP item 17"):
        SpecRounds(Eng(), None, torch.zeros(1, 1), 0, 2)
    with pytest.raises(ValueError, match="ROADMAP item 17"):
        BatchedStep(Eng())
    with pytest.raises(ValueError, match="ROADMAP item 17"):
        BatchedSpecRound(Eng())
    cfg = tiny_llama_config(num_layers=4)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    eng = BatchedEngine(params, cfg, None, num_slots=2, s_max=16, tail_max=4, device="cpu",
                        mesh=MESH2)
    assert eng.mesh is MESH2 and eng.step_graph is None and eng.spec_graph is None
    assert eng.batch_cache.tail_k.shape[2] == cfg.num_kv_heads // 2
