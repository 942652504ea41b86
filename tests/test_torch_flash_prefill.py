"""Plain version of K1 (what `flash_prefill_with_prompt_mass` runs on CPU
tensors) vs the JAX Pallas kernel in interpret mode.

Inputs from a numpy seed, float32. Tolerance: output and prompt mass within
1e-5 absolute (float32 softmax computed blockwise on one side and densely
on the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_kv_cache_compression_tpu.ops.pallas import (
    flash_prefill as jfp)
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
    flash_prefill as tfp)

ATOL = 1e-5


def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,hq,hkv,d,plen,ragged", [
    (2, 128, 4, 2, 16, 32, False),    # GQA, S a tile multiple
    (1, 200, 4, 4, 32, 40, False),    # MHA, S not a tile multiple
    (2, 96, 8, 1, 16, 24, True),      # 8:1 GQA, per-row prompt lengths
    (2, 130, 4, 2, 16, 26, True),     # ragged S and per-row lengths
])
def test_plain_k1_matches_pallas(b, s, hq, hkv, d, plen, ragged):
    q, k, v = _qkv(s + hq, b, s, hq, hkv, d)
    plens = np.array([plen, plen // 3], np.int32)[:b] if ragged else None
    o_j, pm_j = jfp.flash_prefill_with_prompt_mass(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), plen,
        block_q=64, block_k=64, interpret=True,
        prompt_lens=None if plens is None else jnp.asarray(plens))
    o_t, pm_t = tfp.flash_prefill_with_prompt_mass(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), plen,
        prompt_lens=None if plens is None else torch.from_numpy(plens))
    assert o_t.shape == (b, s, hq, d) and pm_t.shape == (b, s)
    np.testing.assert_allclose(np.asarray(o_j), o_t.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(pm_j), pm_t.numpy(), atol=ATOL)


def test_cpu_takes_plain_path_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 16, 2, 1, 16))
    before = tfp.flash_prefill_with_prompt_mass.launches
    o, pm = tfp.flash_prefill_with_prompt_mass(q, k, v, 4)
    o_ref, pm_ref = tfp.prefill_attention_with_prompt_mass(q, k, v, 4)
    assert torch.equal(o, o_ref) and torch.equal(pm, pm_ref)
    assert tfp.flash_prefill_with_prompt_mass.launches == before


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel path, whose checks raise for
    anything that is not a CUDA tensor, instead of silently running the
    plain version."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    k = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfp.flash_prefill_with_prompt_mass(q, k, k, 2)
