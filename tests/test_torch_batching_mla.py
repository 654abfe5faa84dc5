"""The MLA cases of ``tests/test_torch_batching_ops.py`` (the file is split
to keep each under ~60 s on one worker): DeepSeek-V2 MLA + MoE
``decode_step_batched`` and ``refactorize_slot_cache`` over the JAX
``BatchedEngine``'s slot cache (bf16, fp32 and int8 latent factors;
K7's plain version with per-slot ``lengths``) and ``prefill_chunk``,
against the JAX package, with that file's slot state and tolerances."""

import pytest

from tests.test_torch_batching_ops import (
    VARIANTS,
    build_models,
    check_prefill_chunk,
    check_step_and_refold,
    slot_state,
)


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.mark.parametrize("name", [name for name, v in VARIANTS.items() if v[0] == "mla"])
def test_mla_decode_step_batched_and_slot_refold_match_jax(models, name):
    check_step_and_refold(slot_state(models, name))


def test_mla_prefill_chunk_matches_jax(models):
    check_prefill_chunk(models, "mla")
