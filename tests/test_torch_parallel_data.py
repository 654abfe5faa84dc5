"""The mesh's data axis (``parallel.mesh``: rank r at (r // model, r %
model), a model group per data row and a data group per model column;
``InferenceEngine(mesh=...)`` with the batch rows split over the data
ranks) on the CPU, gloo processes on 127.0.0.1 (``tests/_torch_ranks.py``).

The 4-layer tiny model (4 q / 2 kv heads, numpy-seeded fp32 weights, one
xKV-4 group of rank 16 / 16, a 24-token prompt per row, ``tail_max`` 4,
10 tokens: two refolds) in factored pre with fp32 factors and post with
bf16 factors, at b = 2 and b = 4, under ``make_mesh(data=2, model=1)``
(two processes) and ``make_mesh(data=2, model=2)`` (four), against the
unsharded engine in each process (the counterpart of
``tests/test_sharding.py::test_sharded_engine_matches_unsharded``):
  * ``generate``'s tokens equal the unsharded engine's, every row on every
    rank;
  * prefill logits (every row) within 1e-5; each decode step, the first
    and the first after a refold, within 1e-5 of one device over the cache
    joined over both axes (``gather_cache``), and of the unsharded
    engine's own cache within 1e-5 with fp32 factors and within
    ``TOL_BF16`` with bf16 ones: the two sides' SVD inputs differ by ~1e-7
    (a batch of b / 2 rows takes other summation orders than one of b, and
    the model axis sums ``wo`` / ``w_down`` in two halves), which rounds
    single bf16 factor elements the other way (``tests/test_torch_
    parallel.py``'s reason): the first step read up to 3.7e-4, the first
    after a refold up to 1.25e-3 (data 2 x model 2, b = 2), with tokens
    equal;
  * each rank's cache holds its b / 2 rows.
A batch that does not divide the data axis is refused, as the JAX
engine's token sharding refuses it.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import run_ranks  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401
from xkv_tpu_torch.configs import generate_consecutive_xkv_config  # noqa: E402
from xkv_tpu_torch.engine import InferenceEngine  # noqa: E402
from xkv_tpu_torch.models.config import tiny_llama_config  # noqa: E402
from xkv_tpu_torch.models.llama import init_params  # noqa: E402
from xkv_tpu_torch.parallel.mesh import Mesh  # noqa: E402

TOL = 1e-5
# bf16 factors against the unsharded engine's own cache, by step: twice the
# largest readings (module docstring).
TOL_BF16 = {"first": 2 * 3.7e-4, "refold": 2 * 1.25e-3}
MESHES = {"data 2": (2, 1), "data 2 x model 2": (2, 2)}
RUNS = {"pre fp32 b2": ("pre", "fp32", 2), "post bf16 b2": ("post", "bf16", 2),
        "pre fp32 b4": ("pre", "fp32", 4), "post bf16 b4": ("post", "bf16", 4)}
PROMPT, NEW, TAIL = 24, 10, 4

RANK = """
import numpy as np
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.parallel.distributed import allgather_obj
from xkv_tpu_torch.parallel.mesh import make_mesh
from xkv_tpu_torch.parallel.sharding import gather_cache

(data, model), runs, (n_prompt, n_new, tail) = (json.loads(a) for a in argv)
mesh = make_mesh(data=data, model=model)
cfg = tiny_llama_config(num_layers=4, num_q_heads=4, num_kv_heads=2)
params = params_from_numpy(numpy_llama(cfg, 0), device="cpu")
res = {"coords": allgather_obj([mesh.data_rank, mesh.model_rank])}

def diff(a, b):
    return (a - b).abs().max().item()

for label, (rope, fd, b) in runs.items():
    prompt = torch.from_numpy(np.random.default_rng(b).integers(0, cfg.vocab_size,
                                                                (b, n_prompt)))
    xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=4,
                                          rank_k=16, rank_v=16,
                                          extra_kwargs={"rope_mode": rope})
    kw = dict(xkv=xkv, mode="factored", tail_max=tail, cache_dtype=torch.float32,
              factor_dtype=torch.float32 if fd == "fp32" else torch.bfloat16, device="cpu")
    tp = InferenceEngine(params, cfg, mesh=mesh, **kw)
    one = InferenceEngine(params, cfg, **kw)
    tokens = tp.generate(prompt, n_new).tolist()
    row = {"tokens": allgather_obj(tokens), "tokens_one": one.generate(prompt, n_new).tolist()}
    lo, co = one.prefill(prompt)
    lt, ct = tp.prefill(prompt)
    row["prefill"] = diff(lo, lt)
    row["rows"] = [ct.tail_k.shape[1], ct.groups[0].k_us.shape[0], lt.shape[0]]
    toks = torch.tensor(row["tokens_one"])
    pos = n_prompt
    for name in ("first", "refold"):
        i0 = tail if name == "refold" else 0
        if name == "refold":
            for i in range(1, tail + 1):
                _, co = one.decode_step(co, toks[:, i - 1:i], pos + i - 1)
                _, ct = tp.decode_step(ct, toks[:, i - 1:i], pos + i - 1)
            co, ct = one.refactorize(co), tp.refactorize(ct)
        t = toks[:, i0:i0 + 1]
        joined = gather_cache(ct, [4], mesh)
        s_one, _ = one.decode_step(co, t, pos + i0)
        s_join, _ = one.decode_step(joined, t, pos + i0)
        s_tp, _ = tp.decode_step(ct, t, pos + i0)
        row[name] = [diff(s_tp, s_join), diff(s_tp, s_one)]
    res[label] = row
finish(res)
"""


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    data, model = MESHES[request.param]
    out = str(tmp_path_factory.mktemp("tp_data"))
    res = run_ranks(RANK, data * model, out, json.dumps([data, model]), json.dumps(RUNS),
                    json.dumps([PROMPT, NEW, TAIL]))
    return request.param, res


def test_rank_coordinates(ranks):
    name, res = ranks
    data, model = MESHES[name]
    assert res["coords"] == [[r // model, r % model] for r in range(data * model)]


@pytest.mark.parametrize("label", list(RUNS))
def test_data_axis_matches_one_device(ranks, label):
    name, res = ranks
    data, model = MESHES[name]
    row = res[label]
    _, fd, b = RUNS[label]
    # every row on every rank, equal to one device's
    assert all(t == row["tokens_one"] for t in row["tokens"])
    assert np.asarray(row["tokens_one"]).shape == (b, NEW)
    assert row["rows"] == [b // data, b // data, b]  # tail, factors: its rows; logits: all
    assert row["prefill"] <= TOL
    for step in ("first", "refold"):
        joined, one = row[step]
        assert joined <= TOL, (step, joined)
        own = TOL_BF16[step] if fd == "bf16" else TOL
        assert one <= own, (step, one)


def test_a_batch_that_does_not_split_is_refused():
    """b = 3 over a data axis of 2: the JAX engine's token sharding
    refuses it at prefill (a ``device_put`` whose dimension 0 must divide
    the axis), and so does the port, before any collective."""
    from xkv_tpu.engine import InferenceEngine as JaxEngine
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny
    from xkv_tpu.models.llama import init_params as jax_init
    from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh

    prompt = np.zeros((3, 8), np.int32)
    jeng = JaxEngine(jax_init(jax_tiny(), jax.random.PRNGKey(0)), jax_tiny(), mode="none",
                     mesh=jax_make_mesh(data=2, model=1, devices=jax.devices()[:2]))
    with pytest.raises(ValueError, match="divisible by 2"):
        jeng.prefill(prompt)
    cfg = tiny_llama_config()
    eng = InferenceEngine(init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                                      "cpu"), cfg, mode="none", device="cpu",
                          mesh=Mesh(data=2, model=1, rank=0))
    with pytest.raises(ValueError, match="3 rows does not split over a data axis of 2"):
        eng.prefill(prompt)
    xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=2)
    assert InferenceEngine({}, cfg, xkv, device="cpu", mesh=Mesh(data=1, model=1, rank=0)
                           ).mesh is None  # a 1 x 1 mesh is one device
