"""The port's decode pool vs the JAX package's (CPU).

`init_decode_pool` / `flush_recent` / `dequantize_decode_pool` get the same
rings (numpy seed), with rows filled at different rates so that one row
flushes while the other does not, past a wrap of the pool's blocks: pool
bytes, scales, zero points, positions, validity and `write_block` must be
identical (JAX runs eagerly, as its jitted zero point may differ by one
ulp, ROADMAP Queue 3), the dequantized pool within 1e-6.

Whole decode: 2 layers, ring 8, 2 pool blocks, past R * (W + 1) = 24
steps, 4- and 16-bit pools, one and two scale groups per head: the port's
greedy tokens equal JAX's `decode_loop(use_fused=False)` (the plain decode
path over the dequantized pool, which JAX's own tests hold equal to its
Pallas kernel). This mirrors tests/test_decode_pool.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.compression import kv_cache as jk
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu_torch.compression import (
    kv_cache as tk)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from torch_parity import jax_tree, to_torch

RING, BLOCKS, STEPS, PROMPT = 8, 2, 28, 48
POOL_FIELDS = ("k_stored", "v_stored", "k_scale", "k_zp", "v_scale", "v_zp",
               "positions", "valid", "write_block")


def _cfgs(bits, group_size, num_layers=2):
    kw = dict(num_layers=num_layers, decode_pool_blocks=BLOCKS,
              decode_pool_bits=bits, quant_group_size=group_size)
    return rj.CompressionConfig(**kw), rt.CompressionConfig(**kw)


def _assert_pools_equal(pj, pt):
    for f in POOL_FIELDS:
        a, t = np.asarray(getattr(pj, f)), getattr(pt, f)
        if a.dtype.name == "bfloat16":
            a, t = a.view(np.uint16), t.view(torch.int16)
        np.testing.assert_array_equal(a, t.numpy().view(a.dtype),
                                      err_msg=f)


@pytest.mark.parametrize("bits,group_size,dtype", [
    (4, 0, "float32"), (16, 8, "bfloat16")])
def test_flush_recent_matches_jax_over_a_wrap(bits, group_size, dtype):
    """Row 0 appends every step, row 1 every other step: row 0 flushes
    three times, wrapping the two blocks, and row 1 once, at other steps.
    Both flushes get the same rings (built in numpy) at every step."""
    mj = rj.tiny_test_model(num_kv_heads=2, head_dim=16, dtype=dtype)
    mt = rt.tiny_test_model(num_kv_heads=2, head_dim=16, dtype=dtype)
    cj, ct = _cfgs(bits, group_size, num_layers=mj.num_layers)
    b = 2
    pool_j = jk.init_decode_pool(b, RING, cj, mj)
    pool_t = tk.init_decode_pool(b, RING, ct, mt, device="cpu")
    _assert_pools_equal(pool_j, pool_t)
    rng = np.random.default_rng(bits)
    ring = {"k": np.zeros((b, RING, 2, 16), np.float32),
            "v": np.zeros((b, RING, 2, 16), np.float32),
            "positions": np.zeros((b, RING), np.int32),
            "length": np.zeros((b,), np.int32)}
    flushes = np.zeros(b, int)
    for step in range(3 * RING + 1):
        rec_j = jk.RecentCache(**{f: jnp.asarray(a) for f, a in ring.items()})
        rec_j = dataclasses.replace(rec_j, k=rec_j.k.astype(mj.dtype),
                                    v=rec_j.v.astype(mj.dtype))
        rec_t = tk.RecentCache(**{f: to_torch(getattr(rec_j, f))
                                  for f in ring})
        flushes += ring["length"] >= RING
        rec_j, pool_j = jk.flush_recent(rec_j, pool_j, cj, mj)
        tk.flush_recent(rec_t, pool_t, ct, mt)
        _assert_pools_equal(pool_j, pool_t)
        np.testing.assert_array_equal(np.asarray(rec_j.length),
                                      rec_t.length.numpy())
        ring["length"] = np.array(rec_j.length)
        for r in (0,) if step % 2 else (0, 1):  # append, as the ring does
            i = ring["length"][r]
            ring["k"][r, i], ring["v"][r, i] = rng.normal(
                size=(2, 2, 16)) * 3
            ring["positions"][r, i] = 100 + step
            ring["length"][r] += 1
    assert flushes.tolist() == [3, 1]
    for a, t in zip(jk.dequantize_decode_pool(pool_j),
                    tk.dequantize_decode_pool(pool_t)):
        np.testing.assert_allclose(np.asarray(a).astype(np.float32),
                                   t.float().numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def model():
    jcfg = rj.tiny_test_model(num_layers=2)
    tcfg = rt.tiny_test_model(num_layers=2)
    tp = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                            (2, PROMPT))
    return jcfg, tcfg, jax_tree(tp), tp, ids


@pytest.mark.parametrize("bits,group_size", [(4, 8), (16, 0)])
def test_pooled_decode_tokens_equal_jax(model, bits, group_size):
    jcfg, tcfg, jp, tp, ids = model
    cj, ct = _cfgs(bits, group_size)

    @jax.jit
    def run_j(p, i):
        logits, state, _ = jl.prefill_compressed(p, i, jcfg, cj,
                                                 max_decode_len=RING)
        toks, state = jl.decode_loop(p, jnp.argmax(logits, -1), state, STEPS,
                                     jcfg, cj, use_fused=False)
        return toks, state.pools[1]

    toks_j, pool_j = run_j(jp, jnp.asarray(ids))
    logits, state, _ = tl.prefill_compressed(tp, torch.from_numpy(ids), tcfg,
                                             ct, max_decode_len=RING)
    toks_t, state = tl.decode_loop(tp, torch.argmax(logits, -1), state,
                                   STEPS, tcfg, ct)
    np.testing.assert_array_equal(np.asarray(toks_j), toks_t.numpy())
    # Past the wrap: both blocks valid, block 1 next (flushes at steps
    # 8, 16, 24), the ring holds the last 4 tokens.
    assert state.ring_fill == STEPS - 3 * RING
    np.testing.assert_array_equal(np.asarray(pool_j.write_block),
                                  state.pools[1].write_block.numpy())
    np.testing.assert_array_equal(np.asarray(pool_j.positions),
                                  state.pools[1].positions.numpy())
    assert bool(state.pools[1].valid.all())
