"""The training slice on a card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package; run it on the card as

    python -m pytest --noconftest tests/test_torch_train_gpu.py -q

  * the grad guard: K1 refuses an operand that requires grad (no kernel
    has a backward), and runs under ``torch.no_grad``;
  * ``train_lm`` on the card (fp32, the plain prefill attention) launches
    no kernel and follows the same steps on the CPU: losses within 1e-3;
  * ``CompressorTrainer`` (Dual1D) on the card: one K1 launch per layer a
    step, its losses within 1e-2 of the same trainer on the CPU (K1 in
    bf16 against the plain attention in bf16), a checkpoint that loads back
    bitwise;
  * the gates' decode shapes (``tests/test_torch_gate_shapes.py``): each
    kernel at the gate's ranks (zero-padded by its wrapper) against
    the plain decode on the CPU: 2^-6 of the row's largest value (bf16
    outputs), lse 1e-5; and K1 at the gate's prefill (b 32, 4 / 2 heads,
    head size 24, 29 rows).
"""

import numpy as np
import pytest
import torch

from test_torch_gate_shapes import CASES, operands
from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build
from xkv_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain
from xkv_tpu_torch.scripts.kernel_variants import lse_err, row_rel_err
from xkv_tpu_torch.train import CompressorTrainer, TrainConfig
from xkv_tpu_torch.train.lm import train_lm

GATE = tiny_llama_config(vocab_size=64, hidden_size=96, intermediate_size=192, num_layers=3,
                         num_q_heads=4, num_kv_heads=2, head_dim=24)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def qkv(device, b=32, hq=4, hkv=2, s=29, hd=24):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(shape, generator=g).to(torch.bfloat16).to(device)
                 for shape in ((b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))


@pytest.mark.gpu
def test_k1_refuses_operands_that_require_grad(cuda):
    q, k, v = qkv(cuda)
    with pytest.raises(ValueError, match="requires grad"):
        flash_attention(q.requires_grad_(True), k, v, scale=24 ** -0.5)
    _build.reset_counts()
    with torch.no_grad():
        out = flash_attention(q, k, v, scale=24 ** -0.5)
    assert _build.read_counts()["K1"] == 1
    ref = flash_attention_plain(*(t.detach().cpu() for t in (q, k, v)), scale=24 ** -0.5)
    assert row_rel_err(out.cpu(), ref) <= 2.0 ** -6


def llama_to(tree, device):
    if isinstance(tree, dict):
        return {k: llama_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [llama_to(v, device) for v in tree]
    return tree.to(device)


def induction(i, batch=16, m=24):
    rng = np.random.default_rng(i)
    x = rng.integers(2, 64, size=(batch, m)).astype(np.int32)
    tokens = np.concatenate([np.ones((batch, 1), np.int32), x, x], axis=1)
    mask = np.zeros_like(tokens, np.float32)
    mask[:, m + 1:] = 1.0
    return tokens, mask


@pytest.mark.gpu
def test_train_lm_on_the_card_runs_no_kernel(cuda):
    gen = torch.Generator().manual_seed(0)
    cpu = llama.init_params(GATE, gen, torch.float32, "cpu")
    card = llama_to(cpu, cuda)
    _build.reset_counts()
    _, hist = train_lm(card, GATE, induction, steps=5, lr=2e-3, log_every=1)
    assert sum(_build.read_counts().values()) == 0
    _, want = train_lm(cpu, GATE, induction, steps=5, lr=2e-3, log_every=1)
    np.testing.assert_allclose(hist, want, rtol=1e-3)


@pytest.mark.gpu
def test_compressor_trainer_on_the_card(cuda, tmp_path):
    gen = torch.Generator().manual_seed(1)
    cpu = llama.init_params(GATE, gen, torch.bfloat16, "cpu")
    tokens = np.random.default_rng(0).integers(0, 64, size=(2, 64)).astype(np.int32)
    rows = {}
    for name, params, device in (("card", llama_to(cpu, cuda), cuda), ("cpu", cpu, "cpu")):
        tr = CompressorTrainer(params, GATE, TrainConfig(learning_rate=3e-3, warmup_steps=1,
                                                         total_steps=10), device=device)
        tr.init(tokens)
        _build.reset_counts()
        rows[name] = [tr.train_step(tokens)["loss"] for _ in range(3)]
        if name == "card":
            assert _build.read_counts()["K1"] == 3 * GATE.num_layers
            path = str(tmp_path / "dual1d.msgpack")
            tr.save_checkpoint(path)
            back = CompressorTrainer.load_checkpoint(path, params, GATE, tokens, device=cuda)
            for layer, leaves in tr.params.items():
                for leaf, t in leaves.items():
                    assert torch.equal(back.params[layer][leaf], t)
            assert back.eval_step(tokens) == tr.eval_step(tokens)
    np.testing.assert_allclose(rows["card"], rows["cpu"], rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_gate_shapes_match_plain(cuda, name):
    kernel = CASES[name][0]
    fn, args, kw = operands(name, cuda)
    _build.reset_counts()
    out, lse = fn(*args, **kw)
    torch.cuda.synchronize()
    assert _build.read_counts()[kernel] == 1
    _, cargs, ckw = operands(name, "cpu")
    ref, ref_lse = fn(*cargs, **ckw)
    assert row_rel_err(out.cpu(), ref) <= 2.0 ** -6
    assert lse_err(lse.cpu(), ref_lse) <= 1e-5
