"""Run a script as the ranks of a gloo process group on 127.0.0.1, for the
test files that hold the port's mesh against one device on the CPU.

``run_ranks(script, nproc, out_dir, *args)`` starts ``nproc`` Python
processes, each ``python -c script <port> <rank> <nproc> <out_dir>
*args``, waits for them with a timeout of its own (a rank that hangs in a
collective fails the test rather than stalling the suite) and returns
rank 0's ``<out_dir>/rank0.json``, which the script writes with
``finish(res)``. Each rank runs torch on one thread. ``numpy_llama``, a
numpy-seeded Llama-family weight tree that both packages take, is defined
in the script too.
"""

import inspect
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def numpy_llama(cfg, seed: int, scale: float = 0.05) -> dict:
    """A Llama-family weight tree (the JAX package's, fp32 numpy) from
    ``numpy.random.default_rng(seed)``: normal(0, ``scale``) projections,
    embeddings and ``lm_head``, unit norms. Both packages can be given it
    (the port through ``models.ckpt.params_from_numpy``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, hd = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    layers = [{"attn": {"wq": dense(d, hq * hd), "wk": dense(d, hkv * hd),
                        "wv": dense(d, hkv * hd), "wo": dense(hq * hd, d)},
               "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f), "w_down": dense(f, d)},
               "input_norm": np.ones(d, np.float32), "post_norm": np.ones(d, np.float32)}
              for _ in range(cfg.num_layers)]
    return {"embed": dense(cfg.vocab_size, d), "layers": layers,
            "final_norm": np.ones(d, np.float32), "lm_head": dense(d, cfg.vocab_size)}


# The script's preamble: its arguments, one torch thread, the group joined.
PREAMBLE = """
import json, sys
import torch
from xkv_tpu_torch.parallel.distributed import barrier, init_distributed

port, rank, nproc, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
argv = sys.argv[5:]
torch.set_num_threads(1)
init_distributed("gloo", coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
                 process_id=rank, timeout_s=120)


def finish(res):
    barrier()
    if rank == 0:
        with open(out + "/rank0.json", "w") as f:
            json.dump(res, f)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, nproc: int, out_dir: str, *args: str, timeout: float = 240) -> dict:
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    source = PREAMBLE + inspect.getsource(numpy_llama) + script
    procs = [subprocess.Popen([sys.executable, "-c", source, str(port), str(r),
                               str(nproc), str(out_dir), *args], cwd=ROOT, env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(nproc)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(os.path.join(out_dir, "rank0.json")) as f:
        return json.load(f)
