"""Chunked prefill in the port vs the JAX package, and vs the port's own
one-shot prefill (CPU).

`chunk_attention_with_prompt_mass` (K1 mode (b)'s plain version, what
`flash_chunk_attention_with_prompt_mass` runs on CPU tensors) against
JAX's at the buffer's start and mid-buffer, with per-row prompt lengths:
outputs and prompt mass within 1e-5 (float32, softmax sums in another
order).

`prefill_compressed_chunked` on a ragged 2-layer batch (lengths (128, 93),
chunks of 32) against JAX's: kept positions and validity identical, packed
codes within the whole-model limit (tests/torch_parity.py), logits within
1e-4. Then the port's chunked path against its one-shot
`prefill_compressed(lengths=)`: identical positions and end positions,
logits within 1e-4, and 7 equal greedy steps, as
tests/test_chunked_prefill.py holds the JAX package's two paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import attention as ja
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
    flash_prefill as tfp)
from torch_parity import assert_caches_match, jax_tree

LAYERS, BATCH, PROMPT, CHUNK = 2, 2, 128, 32
LENGTHS = (128, 93)
ATOL_ATTN = 1e-5
ATOL_LOGITS = 1e-4


@pytest.mark.parametrize("q_offset", [0, 40])
def test_chunk_attention_matches_jax(q_offset):
    rng = np.random.default_rng(q_offset)
    b, c, s, hq, hkv, d = 2, 24, 96, 8, 2, 16
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, s, hkv, d)).astype(np.float32)
    plens = np.array([5, 17], np.int32)
    out_j, pm_j = jax.jit(ja.chunk_attention_with_prompt_mass,
                          static_argnums=(4,))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset, 19,
        prompt_lens=jnp.asarray(plens))
    out_t, pm_t = tfp.flash_chunk_attention_with_prompt_mass(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset, 19, prompt_lens=torch.from_numpy(plens))
    assert out_t.shape == q.shape and pm_t.shape == (b, c)
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(),
                               atol=ATOL_ATTN)
    np.testing.assert_allclose(np.asarray(pm_j), pm_t.numpy(),
                               atol=ATOL_ATTN)


@pytest.fixture(scope="module")
def runs():
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    jcc = rj.CompressionConfig(num_layers=LAYERS)
    tcc = rt.CompressionConfig(num_layers=LAYERS)
    tp = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                            (BATCH, PROMPT))
    lengths = np.asarray(LENGTHS, np.int32)
    j_logits, j_state, _ = jax.jit(
        lambda p, i, n: jl.prefill_compressed_chunked(
            p, i, jcfg, jcc, chunk_size=CHUNK, max_decode_len=8, lengths=n,
            jit_steps=False))(jax_tree(tp), jnp.asarray(ids),
                              jnp.asarray(lengths))
    ids_t, lengths_t = torch.from_numpy(ids), torch.from_numpy(lengths)
    chunked = tl.prefill_compressed_chunked(
        tp, ids_t, tcfg, tcc, chunk_size=CHUNK, max_decode_len=8,
        lengths=lengths_t)
    one_shot = tl.prefill_compressed(tp, ids_t, tcfg, tcc, max_decode_len=8,
                                     lengths=lengths_t)
    return dict(tp=tp, tcfg=tcfg, tcc=tcc, j_logits=j_logits,
                j_state=j_state, chunked=chunked, one_shot=one_shot)


def test_chunked_prefill_matches_jax(runs):
    t_logits, t_state, _ = runs["chunked"]
    np.testing.assert_allclose(np.asarray(runs["j_logits"]),
                               t_logits.numpy(), atol=ATOL_LOGITS)
    np.testing.assert_array_equal(np.asarray(runs["j_state"].position),
                                  t_state.position.numpy())
    assert_caches_match(runs["j_state"].caches, t_state.caches, runs["tcc"])


def test_chunked_matches_one_shot_prefill(runs):
    (lo_c, st_c, stats_c), (lo_1, st_1, stats_1) = (runs["chunked"],
                                                    runs["one_shot"])
    np.testing.assert_allclose(lo_c.numpy(), lo_1.numpy(), atol=ATOL_LOGITS)
    assert torch.equal(st_c.position, st_1.position)
    for cache_c, cache_1 in zip(st_c.caches, st_1.caches):
        for a, b in zip(cache_c.tiers, cache_1.tiers):
            assert torch.equal(a.positions, b.positions)
            assert torch.equal(a.valid, b.valid)
    for a, b in zip(stats_c, stats_1):
        for key in a:
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                       rtol=1e-5, err_msg=key)
    tp, tcfg, tcc = runs["tp"], runs["tcfg"], runs["tcc"]
    o_c, _ = tl.decode_loop(tp, torch.argmax(lo_c, -1), st_c, 7, tcfg, tcc)
    o_1, _ = tl.decode_loop(tp, torch.argmax(lo_1, -1), st_1, 7, tcfg, tcc)
    assert torch.equal(o_c, o_1)


def test_chunked_rejects_nondivisible_chunk(runs):
    with pytest.raises(ValueError):
        tl.prefill_compressed_chunked(runs["tp"], torch.zeros((1, 50),
                                                              dtype=torch.long),
                                      runs["tcfg"], runs["tcc"],
                                      chunk_size=16)
