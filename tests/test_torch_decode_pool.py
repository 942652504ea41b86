"""The port's decode pool vs the JAX package's (CPU).

`init_decode_pool` / `flush_recent` / `dequantize_decode_pool` get the same
rings (numpy seed), with rows filled at different rates so that one row
flushes while the other does not, past a wrap of the pool's blocks: pool
bytes, scales, zero points, positions, validity and `write_block` must be
identical (JAX runs eagerly, as its jitted zero point may differ by one
ulp, ROADMAP Queue 3), the dequantized pool within 1e-6.

Rows at different ring fills: the port's host-side per-row bookkeeping
(`ring_fill_step`, run by `decode_step`) decides when to flush; the pools
stay identical to JAX's flush-and-append every step.

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


@pytest.mark.parametrize("fills", [(5, 0), (0, 7)])
def test_rows_at_different_ring_fills_match_jax(fills):
    """Rows whose rings hold different counts (`fills`, as a server that
    admits rows at other times would state them in `DecodeState.ring_fill`)
    through 3 R + 1 steps. The port decides each step's flush from its
    host-side per-row fills (`ring_fill_step`, what `decode_step` runs),
    the JAX package flushes and appends every step (its `decode_step`).
    Same rings and appended K/V on both sides (numpy): pool bytes, scales,
    positions, validity and `write_block` identical after every step,
    ring lengths equal to the host fills, and each row flushes on its own
    steps."""
    mj = rj.tiny_test_model(num_kv_heads=2, head_dim=16)
    mt = rt.tiny_test_model(num_kv_heads=2, head_dim=16)
    cj, ct = _cfgs(4, 8, num_layers=mj.num_layers)
    b = len(fills)
    rng = np.random.default_rng(sum(fills))
    ring = {"k": rng.normal(size=(b, RING, 2, 16)).astype(np.float32),
            "v": rng.normal(size=(b, RING, 2, 16)).astype(np.float32),
            "positions": np.tile(np.arange(RING, dtype=np.int32), (b, 1)),
            "length": np.array(fills, np.int32)}
    rec_j = jk.RecentCache(**{f: jnp.asarray(a) for f, a in ring.items()})
    rec_t = tk.RecentCache(**{f: torch.from_numpy(a.copy())
                              for f, a in ring.items()})
    pool_j = jk.init_decode_pool(b, RING, cj, mj)
    pool_t = tk.init_decode_pool(b, RING, ct, mt, device="cpu")
    host, flushed = tuple(fills), []
    for step in range(3 * RING + 1):
        flush, host = tl.ring_fill_step(host, RING, pooled=True)
        if flush:
            flushed.append(step)
            tk.flush_recent(rec_t, pool_t, ct, mt)
        rec_j, pool_j = jk.flush_recent(rec_j, pool_j, cj, mj)
        kv = rng.normal(size=(2, b, 1, 2, 16)).astype(np.float32) * 3
        pos = np.full((b, 1), 100 + step, np.int32)
        rec_j = jk.append_recent(rec_j, jnp.asarray(kv[0]),
                                 jnp.asarray(kv[1]), jnp.asarray(pos))
        tk.append_recent(rec_t, torch.from_numpy(kv[0]),
                         torch.from_numpy(kv[1]), torch.from_numpy(pos))
        _assert_pools_equal(pool_j, pool_t)
        assert list(host) == rec_t.length.tolist() == np.asarray(
            rec_j.length).tolist()
    # Each row flushes when its own ring is full: row r at steps
    # RING - fills[r], then every RING steps.
    assert flushed == sorted({RING - f + RING * i for f in fills
                              for i in range(4)
                              if RING - f + RING * i <= 3 * RING})


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
    assert state.ring_fill == (STEPS - 3 * RING,) * 2
    np.testing.assert_array_equal(np.asarray(pool_j.write_block),
                                  state.pools[1].write_block.numpy())
    np.testing.assert_array_equal(np.asarray(pool_j.positions),
                                  state.pools[1].positions.numpy())
    assert bool(state.pools[1].valid.all())
