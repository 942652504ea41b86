"""Plain version of K2 (what `fused_decode_attention` runs on CPU tensors)
vs the JAX Pallas kernel in interpret mode, on caches built by the JAX
package's `compress_layer_kv` and converted to the port's containers.

Inputs from a numpy seed, float32. Tolerance: 1e-5 absolute on the
attention output (dequantize-then-attend on one side, rank-1 folded
dequant inside the online softmax on the other).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.compression import (
    append_recent, compress_layer_kv, init_recent_cache)
from realtime_kv_cache_compression_tpu.ops.pallas import (
    decode_attention as jda)
from realtime_kv_cache_compression_tpu_torch.compression import (
    kv_cache as tk)
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
    decode_attention as tda)
from torch_parity import cache_to_torch, to_torch

ATOL = 1e-5

# Jitted with static configs: one compile per case is cheaper than eager
# dispatch of the interpreted kernel's grid.
_compress = jax.jit(compress_layer_kv, static_argnums=(3, 4, 5))
_pallas_k2 = jax.jit(functools.partial(jda.fused_decode_attention,
                                       interpret=True), static_argnums=(4,))


def _state(seed, ccfg_kw, b=2, s=96, hq=4, hkv=2, d=32, ring=8, n_recent=3):
    kw = dict(num_heads=hq, num_kv_heads=hkv, head_dim=d)
    mcfg = rj.tiny_test_model(**kw)
    if ccfg_kw == "anchor":
        cj = rj.reference_anchor_config(num_layers=mcfg.num_layers)
        ct = rt.reference_anchor_config(num_layers=mcfg.num_layers)
    else:
        cj = rj.CompressionConfig(num_layers=mcfg.num_layers, **ccfg_kw)
        ct = rt.CompressionConfig(num_layers=mcfg.num_layers, **ccfg_kw)
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    mass = rng.random((b, s)).astype(np.float32)
    cache, _ = _compress(jnp.asarray(k), jnp.asarray(v), jnp.asarray(mass),
                         0, cj, mcfg)
    recent = init_recent_cache(b, ring, mcfg, dtype=jnp.float32)
    for i in range(n_recent):
        kn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
        vn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
        recent = append_recent(recent, jnp.asarray(kn), jnp.asarray(vn),
                               jnp.full((b, 1), s + i, jnp.int32))
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    q_pos = np.full((b, 1), s + n_recent, np.int32)
    q_pos[-1, 0] -= 2  # a row whose newest ring token is in its future
    cache_t = cache_to_torch(cache)
    recent_t = tk.RecentCache(**{f: to_torch(getattr(recent, f))
                                 for f in ("k", "v", "positions", "length")})
    return (jnp.asarray(q), cache, recent, jnp.asarray(q_pos), cj,
            torch.from_numpy(q), cache_t, recent_t, torch.from_numpy(q_pos),
            ct)


@pytest.mark.parametrize("name,ccfg_kw,shape", [
    ("tiers_8_4_2", {}, {}),
    ("tiers_16_8_4_anchor", "anchor", {}),
    ("multi_chunk", dict(pack_chunk_tokens=16), dict(s=256)),
    ("mha_d16_empty_ring", {}, dict(hq=4, hkv=4, d=16, n_recent=0)),
    ("threshold_full_ring", dict(tier_mode="threshold"),
     dict(ring=4, n_recent=4)),
    ("gemma_d256_groups", dict(quant_group_size=64),
     dict(hq=2, hkv=1, d=256)),
])
def test_plain_k2_matches_pallas(name, ccfg_kw, shape):
    (qj, cache_j, rec_j, qpos_j, cj,
     qt, cache_t, rec_t, qpos_t, ct) = _state(len(name), ccfg_kw, **shape)
    out_j = _pallas_k2(qj, cache_j, rec_j, qpos_j, cj)
    out_t = tda.fused_decode_attention(qt, cache_t, rec_t, qpos_t, ct)
    assert out_t.shape == tuple(qt.shape)
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(), atol=ATOL)


def test_unported_arguments_raise():
    """The pool and scale groups are ported; off the CPU the wrapper still
    refuses groups of fewer than 8 channels and any non-CUDA tensor."""
    (_, _, _, _, _, qt, cache_t, rec_t, qpos_t, ct) = _state(0, {})
    q_meta = torch.empty(tuple(qt.shape), device="meta")
    four = tk.CompressedLayerCache(tiers=tuple(  # d=32: 8 groups of 4
        dataclasses.replace(t, k_scale=t.k_scale.expand(*t.k_scale.shape[:3],
                                                        8))
        for t in cache_t.tiers))
    with pytest.raises(ValueError, match="scale groups"):
        tda.fused_decode_attention(q_meta, four, rec_t, qpos_t, ct)
    with pytest.raises(ValueError, match="CUDA"):
        tda.fused_decode_attention(q_meta, cache_t, rec_t, qpos_t, ct)


@pytest.mark.parametrize("d,elem,groups", [(64, 2, 1), (128, 2, 4),
                                           (256, 4, 32), (16, 4, 2)])
def test_tiles_fit_the_kernels_shared_memory(d, elem, groups):
    """A tile holds at most lim.tile_tokens tokens, lim.tile_bytes of K
    rows and, with G > 1, lim.grouped_scales tokens x groups, for every
    segment kind. The limits a CUDA call plans by come from the built
    library (`kernel_limits`); here two sets stand in for them, the
    kernel's (kTileTokens, kTileBytes, kGroupedScales, kMaxSplits in the
    CUDA source) and a tighter one."""
    for lim in (tda.DecodeLimits(256, 16384, 1024, 64),
                tda.DecodeLimits(64, 4096, 256, 16)):
        for bits in (2, 4, 8, 16):
            per = 1 if bits == 16 else 8 // bits
            row_bytes = d * elem if bits == 16 else d
            rows = tda._tile_rows(bits, row_bytes, groups, lim)
            assert rows >= 1 and per * rows <= lim.tile_tokens
            assert rows * row_bytes <= lim.tile_bytes
            if bits != 16:
                assert per * rows * groups <= lim.grouped_scales


@pytest.mark.parametrize("b,hkv,d", [(1, 4, 64), (1, 32, 128), (1, 1, 256),
                                     (2, 4, 64), (64, 32, 128)])
def test_split_plan_covers_every_row_in_whole_tiles(b, hkv, d):
    """Tiers 8/4/2 in chunks of 128 tokens (capacities of a 4096-token
    prefill) and a 128-token bf16 ring: the splits cover each segment's
    rows once, cut only between whole tiles, hold about the same number of
    tiles, and stay within TARGET_BLOCKS / (B Hkv) per (row, kv head) (at
    most MAX_SPLITS_PER_HEAD, at least one per segment)."""
    lim = tda.DecodeLimits(256, 16384, 1024, 64)  # the kernel's
    segs = []
    for bits, tokens in ((8, 1024), (4, 2048), (2, 1024), (16, 128)):
        seg = tda.DecodeSegment()
        per = 1 if bits == 16 else 8 // bits
        chunk = tokens if bits == 16 else 128
        seg.rows, seg.bits = tokens // per, bits
        seg.rows_per_chunk = chunk // per
        seg.tile_rows = tda._tile_rows(bits, 2 * d if bits == 16 else d, 1,
                                       lim)
        segs.append(seg)
    splits = tda._plan_splits(segs, b, hkv)
    target = max(len(segs), min(tda.MAX_SPLITS_PER_HEAD,
                                tda.TARGET_BLOCKS // (b * hkv)))
    assert len(segs) <= splits <= min(lim.max_splits, target)
    start, tiles = 0, set()
    for seg in segs:
        unit = min(seg.tile_rows, seg.rows_per_chunk)
        assert seg.split_start == start
        assert seg.rows_per_split % unit == 0
        assert (seg.n_splits - 1) * seg.rows_per_split < seg.rows
        assert seg.n_splits * seg.rows_per_split >= seg.rows
        tiles.add(seg.rows_per_split // unit)
        start += seg.n_splits
    assert start == splits and len(tiles) == 1
    if target > len(segs):
        assert splits > target // 2
