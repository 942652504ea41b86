"""Compressed-prefix chunked prefill in the port vs the JAX package (CPU).

Each piece is held against its JAX counterpart on the same numpy inputs,
float32, at `tiny_test_model(num_layers=3)` sizes:

- `importance_scores` of a chunk (position_offset, total_len, minmax)
  within 1e-6 (the log bias may differ in the last bit between the two
  frameworks' log);
- `select_tokens(total_len=)` fed JAX's scores and labels: identical;
- `compress_layer_kv_chunked` (per-chunk `compress_layer_kv` with the
  three new arguments, `concat_layer_caches`), uniform and ragged:
  identical packed bytes, positions, validity and chunks;
- `empty_layer_cache` shapes, dtypes and chunks, `update_cache_chunk`:
  identical;
- the dense `positioned_attention_with_prompt_mass` (invalid slots, a row
  with no visible key, prompt columns) within 1e-5;
- the plain partials (`flash_*` on CPU tensors) against JAX's Pallas
  kernels in interpret mode, one call per entry point: the diagonal pair
  and mode (d) within 1e-5, lse compared on rows that see a key (the
  port gives -inf on the others, the TPU kernel a finite value below
  -1e30); mode (c) against JAX's dense attention (no interpret-mode call),
  lse against a float64 log-sum-exp;
- `merge_attention_partials` within 1e-6;
- the whole path, B=2, S=64, chunks of 16, both `use_flash` arms against
  JAX's dense arm: logits within 1e-4, kept positions and validity
  identical (codes within the whole-model limit of tests/torch_parity.py),
  8 equal greedy tokens through `decode_loop`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.compression import compressor as jc
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import attention as ja
from realtime_kv_cache_compression_tpu.ops import importance as ji
from realtime_kv_cache_compression_tpu.ops import quantization as jq
from realtime_kv_cache_compression_tpu.ops import selection as js
from realtime_kv_cache_compression_tpu.ops.pallas import flash_prefill as jfp
from realtime_kv_cache_compression_tpu_torch import compression as tc
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops import attention as ta
from realtime_kv_cache_compression_tpu_torch.ops import importance as ti
from realtime_kv_cache_compression_tpu_torch.ops import selection as ts
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
    flash_prefill as tfp)
from torch_parity import assert_caches_match, jax_tree

LAYERS, BATCH, SEQ, CHUNK, STEPS = 3, 2, 64, 16, 8
ATOL_SCORES = 1e-6
ATOL_ATTN = 1e-5
ATOL_LOGITS = 1e-4

CASES = {
    "recency": {},
    "log_bias": dict(position_bias_mode="log", prompt_region_floor=0.0),
    "sinks": dict(sink_tokens=3, prompt_region_floor=0.5),
    "threshold": dict(tier_mode="threshold", theta_h=0.6, theta_m=0.3),
    "anchor_16_8_4": "anchor",
}


def _cfgs(case, **extra):
    kw = CASES[case]
    if kw == "anchor":
        return (rj.reference_anchor_config(num_layers=LAYERS, **extra),
                rt.reference_anchor_config(num_layers=LAYERS, **extra))
    return (rj.CompressionConfig(num_layers=LAYERS, **kw, **extra),
            rt.CompressionConfig(num_layers=LAYERS, **kw, **extra))


def _chunk_inputs(seed, b=2, s_loc=32, n_chunks=4):
    """A chunk's mass and the global min-max of its whole sequence."""
    mass = np.random.default_rng(seed).random((b, s_loc * n_chunks)).astype(
        np.float32)
    mn, mx = (f(mass, axis=-1, keepdims=True) for f in (np.min, np.max))
    return mass, mn, mx


def _j_scores(mass, mn, mx, layer, s, plen, cfg, off, total, lengths=None):
    fn = jax.jit(lambda m, a, b, n: ji.importance_scores(
        m, layer, s, plen, cfg, lengths=n, position_offset=off,
        total_len=total, minmax=(a, b)))
    return fn(jnp.asarray(mass), jnp.asarray(mn), jnp.asarray(mx),
              None if lengths is None else jnp.asarray(lengths))


@pytest.mark.parametrize("case,layer,ragged", [
    ("recency", 0, False), ("log_bias", 2, False), ("sinks", 1, True)])
def test_importance_scores_of_a_chunk(case, layer, ragged):
    cj, ct = _cfgs(case)
    mass, mn, mx = _chunk_inputs(layer)
    s_loc, off, total = 32, 64, mass.shape[1]
    lengths = np.array([total, 100], np.int32) if ragged else None
    chunk = mass[:, off:off + s_loc]
    plen = cj.prompt_length(total)
    sj = _j_scores(chunk, mn, mx, layer, s_loc, plen, cj, off, total,
                   lengths)
    st = ti.importance_scores(
        torch.from_numpy(chunk), layer, s_loc, plen, ct,
        lengths=None if lengths is None else torch.from_numpy(lengths),
        position_offset=off, total_len=total,
        minmax=(torch.from_numpy(mn), torch.from_numpy(mx)))
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=ATOL_SCORES)


@pytest.mark.parametrize("case,layer", [("sinks", 0), ("threshold", 2)])
def test_select_tokens_local_window(case, layer):
    """Local selection (total_len set) keeps uniform capacities: no anchor
    growth of the HIGH tier. Fed JAX's scores, so float ties cannot flip."""
    cj, ct = _cfgs(case)
    mass, mn, mx = _chunk_inputs(10 + layer)
    s_loc, total = 32, mass.shape[1]

    @jax.jit
    def j_select(m, a, b):
        scores = ji.importance_scores(m, layer, s_loc, cj.prompt_length(total),
                                      cj, position_offset=0, total_len=total,
                                      minmax=(a, b))
        labels, _ = jq.assign_precision(scores, cj)
        return scores, labels, js.select_tokens(scores, labels, layer, cj,
                                                total_len=total)

    scores, labels, sel_j = j_select(jnp.asarray(mass[:, :s_loc]),
                                     jnp.asarray(mn), jnp.asarray(mx))
    sel_t = ts.select_tokens(torch.from_numpy(np.array(scores)),
                             torch.from_numpy(np.array(labels)), layer, ct,
                             total_len=total)
    for a, b in zip(sel_j.indices + sel_j.valid, sel_t.indices + sel_t.valid):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(sel_j.kept_mask),
                                  sel_t.kept_mask.numpy())
    for key in sel_j.stats:
        np.testing.assert_allclose(np.asarray(sel_j.stats[key]),
                                   sel_t.stats[key].numpy(), rtol=1e-6,
                                   err_msg=key)


def _assert_same_cache(cache_j, cache_t):
    """Identical fields (packed bytes included) and chunks."""
    for a, t in zip(cache_j.tiers, cache_t.tiers):
        assert a.chunk == t.chunk
        for f in ("k_stored", "v_stored", "positions", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(t, f).numpy(), err_msg=f)
        for f in ("k_scale", "k_zp", "v_scale", "v_zp"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                       getattr(t, f).numpy(), rtol=1e-6,
                                       err_msg=f)


def test_compress_layer_kv_chunked_ragged():
    """Per-chunk `compress_layer_kv(shard_offset, total_len, minmax,
    chunk_lengths)` on ragged rows and `concat_layer_caches`, through
    `compress_layer_kv_chunked` (uniform rows: the next test)."""
    cj, ct = _cfgs("sinks")
    layer = 2
    mcfg_j = rj.tiny_test_model(num_layers=LAYERS)
    mcfg_t = rt.tiny_test_model(num_layers=LAYERS)
    rng = np.random.default_rng(20 + layer)
    b, s, n_chunks = 2, 64, 2
    k, v = rng.normal(size=(2, b, s, 2, 16)).astype(np.float32)
    mass = rng.random((b, s)).astype(np.float32)
    valid = np.arange(s)[None] < np.array([[s], [45]])
    plens = np.array([16, 11], np.int32)
    args = (k, v, mass, valid, plens)
    cache_j, st_j = jax.jit(
        lambda k_, v_, m_, tv, pl: jc.compress_layer_kv_chunked(
            k_, v_, m_, layer, cj, mcfg_j, n_chunks, token_valid=tv,
            prompt_lens=pl))(*map(jnp.asarray, args))
    cache_t, st_t = tc.compress_layer_kv_chunked(
        *map(torch.from_numpy, args[:3]), layer, ct, mcfg_t, n_chunks,
        token_valid=torch.from_numpy(valid),
        prompt_lens=torch.from_numpy(plens))
    _assert_same_cache(cache_j, cache_t)
    assert set(st_j) == set(st_t)
    for key in st_j:
        np.testing.assert_allclose(np.asarray(st_j[key]), st_t[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("case,layouts", [
    ("recency", [(n, layer) for n in (1, 4) for layer in range(LAYERS)]),
    ("anchor_16_8_4", [(4, 0)])])  # its HIGH tier stores raw 16-bit
def test_empty_layer_cache_matches_jax(case, layouts):
    """Shapes, dtypes and packing chunks, for 1 and 4 chunks, in an early,
    a middle and a late layer."""
    cj, ct = _cfgs(case)
    mcfg_j = rj.tiny_test_model(num_layers=LAYERS)
    mcfg_t = rt.tiny_test_model(num_layers=LAYERS)
    for n_chunks, layer in layouts:
        a = jc.empty_layer_cache(BATCH, SEQ // n_chunks, n_chunks, layer,
                                 cj, mcfg_j)
        t = tc.empty_layer_cache(BATCH, SEQ // n_chunks, n_chunks, layer,
                                 ct, mcfg_t, device="cpu")
        for ta_, tt in zip(a.tiers, t.tiers):
            assert ta_.chunk == tt.chunk
            for f in ("k_stored", "v_stored", "k_scale", "k_zp",
                      "v_scale", "v_zp", "positions", "valid"):
                x, y = getattr(ta_, f), getattr(tt, f)
                assert tuple(x.shape) == tuple(y.shape), f
                assert str(x.dtype) == str(y.dtype).replace("torch.",
                                                            ""), f
                assert not bool(y.any())


def test_compress_chunk_and_update_cache_chunk_match_jax():
    """One uniform chunk through `compress_layer_kv(shard_offset,
    total_len, minmax)` on both sides, then written into slot range 2."""
    cj, ct = _cfgs("recency")
    mcfg_j = rj.tiny_test_model(num_layers=LAYERS)
    mcfg_t = rt.tiny_test_model(num_layers=LAYERS)
    rng = np.random.default_rng(3)
    k, v = rng.normal(size=(2, BATCH, CHUNK, 2, 16)).astype(np.float32)
    mass = rng.random((BATCH, CHUNK)).astype(np.float32)
    mn, mx = mass.min(-1, keepdims=True), mass.max(-1, keepdims=True)
    small, _ = jax.jit(lambda *a: jc.compress_layer_kv(
        *a[:3], 1, cj, mcfg_j, shard_offset=2 * CHUNK, total_len=SEQ,
        minmax=a[3:]))(*map(jnp.asarray, (k, v, mass, mn, mx)))
    big_j = jc.update_cache_chunk(
        jc.empty_layer_cache(BATCH, CHUNK, SEQ // CHUNK, 1, cj, mcfg_j),
        small, 2)
    small_t, _ = tc.compress_layer_kv(
        *map(torch.from_numpy, (k, v, mass)), 1, ct, mcfg_t,
        shard_offset=2 * CHUNK, total_len=SEQ,
        minmax=tuple(map(torch.from_numpy, (mn, mx))))
    _assert_same_cache(small, small_t)
    big_t = tc.empty_layer_cache(BATCH, CHUNK, SEQ // CHUNK, 1, ct, mcfg_t,
                                 device="cpu")
    assert tc.update_cache_chunk(big_t, small_t, 2) is big_t
    _assert_same_cache(big_j, big_t)


def test_positioned_attention_dense_matches_jax():
    rng = np.random.default_rng(4)
    b, c, n, hq, hkv, d = 2, 12, 30, 4, 2, 16
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, n, hkv, d)).astype(np.float32)
    k_pos = rng.integers(0, 40, (b, n)).astype(np.int32)
    k_valid = rng.random((b, n)) < 0.7
    k_valid[0] &= k_pos[0] >= 30       # row 0: queries 28, 29 see no key
    q_pos = np.broadcast_to(28 + np.arange(c, dtype=np.int32), (b, c))
    out_j, pm_j = jax.jit(ja.positioned_attention_with_prompt_mass,
                          static_argnums=(6,))(
        *map(jnp.asarray, (q, k, v, k_pos, k_valid, q_pos)), 20)
    out_t, pm_t = ta.positioned_attention_with_prompt_mass(
        *map(torch.from_numpy, (q, k, v, k_pos, k_valid)),
        torch.from_numpy(q_pos.copy()), 20)
    assert float(out_t[0, :2].abs().max()) == 0.0
    assert float(pm_t[0, :2].abs().max()) == 0.0
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(),
                               atol=ATOL_ATTN)
    np.testing.assert_allclose(np.asarray(pm_j), pm_t.numpy(),
                               atol=ATOL_ATTN)


def _assert_partials_close(part_j, part_t):
    """o and pm within ATOL_ATTN; lse within it on rows that see a key,
    at or below -1e30 on both sides elsewhere (the port gives -inf)."""
    (o_j, lse_j, pm_j), (o_t, lse_t, pm_t) = part_j, part_t
    np.testing.assert_allclose(np.asarray(o_j), o_t.numpy(), atol=ATOL_ATTN)
    np.testing.assert_allclose(np.asarray(pm_j), pm_t.numpy(),
                               atol=ATOL_ATTN)
    lse_j, lse_t = np.asarray(lse_j), lse_t.numpy()
    sees = np.isfinite(lse_t)
    assert bool((lse_j[~sees] <= -1e30).all())
    assert bool(np.all(lse_t[~sees] == -np.inf))
    np.testing.assert_allclose(lse_j[sees], lse_t[sees], atol=ATOL_ATTN)


def test_diagonal_pair_matches_jax_interpret():
    rng = np.random.default_rng(5)
    b, c, hq, hkv, d = 2, 16, 4, 2, 16
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, c, hkv, d)).astype(np.float32)
    plen = np.array([5, 0], np.int32)
    part_j = jfp.flash_pair_attention(*map(jnp.asarray, (q, k, v, plen)),
                                      causal=True, interpret=True)
    part_t = tfp.flash_pair_attention(*map(torch.from_numpy, (q, k, v, plen)),
                                      causal=True)
    _assert_partials_close(part_j, part_t)


def test_positioned_partial_matches_jax_interpret():
    """Pool slots at scattered positions with invalid ones at POS_SENTINEL;
    row 0 of batch 0 sees no key, batch 1's pool is all invalid (the
    first chunk's case)."""
    rng = np.random.default_rng(6)
    b, c, n, hq, hkv, d = 2, 16, 40, 4, 2, 16
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, n, hkv, d)).astype(np.float32)
    k_pos = rng.integers(33, 60, (b, n)).astype(np.int32)
    k_pos[rng.random((b, n)) < 0.3] = tfp.POS_SENTINEL
    k_pos[1] = tfp.POS_SENTINEL
    q_offset, prompt_len = 32, 45
    part_j = jfp.flash_positioned_attention(
        *map(jnp.asarray, (q, k, v, k_pos)), q_offset, prompt_len,
        interpret=True)
    part_t = tfp.flash_positioned_attention(
        *map(torch.from_numpy, (q, k, v, k_pos)), q_offset, prompt_len)
    assert not np.isfinite(part_t[1][0, :, 0].numpy()).any()
    assert not np.isfinite(part_t[1][1].numpy()).any()
    _assert_partials_close(part_j, part_t)


def test_full_pair_matches_dense_reference():
    """Mode (c): out and head-averaged mass against JAX's dense non-causal
    attention; per-head lse against float64 log-sum-exp."""
    rng = np.random.default_rng(7)
    b, sq, sk, hq, hkv, d = 2, 12, 20, 4, 2, 16
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, sk, hkv, d)).astype(np.float32)
    o_t, lse_t, pm_t = tfp.flash_pair_attention(
        *map(torch.from_numpy, (q, k, v)), 7, causal=False)
    # The dense reference is square: append sk - sq dummy query rows.
    q_sq = np.concatenate([q, np.zeros((b, sk - sq, hq, d), np.float32)], 1)
    o_j, pm_j = jax.jit(ja.prefill_attention_with_prompt_mass,
                        static_argnums=(3, 4))(
        *map(jnp.asarray, (q_sq, k, v)), 7, False)
    np.testing.assert_allclose(np.asarray(o_j)[:, :sq], o_t.numpy(),
                               atol=ATOL_ATTN)
    np.testing.assert_allclose(np.asarray(pm_j)[:, :sq],
                               pm_t.mean(dim=1).numpy(), atol=ATOL_ATTN)
    kr = np.repeat(k.astype(np.float64), hq // hkv, axis=2)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / d ** 0.5
    top = logits.max(-1, keepdims=True)
    lse = (top + np.log(np.exp(logits - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse, lse_t.numpy(), atol=ATOL_ATTN)


def test_merge_attention_partials_matches_jax():
    """Two parts over disjoint key sets; the first is -inf on some rows (a
    pool no row of which is visible yet), never both."""
    rng = np.random.default_rng(8)
    b, s, hq, d = 2, 10, 4, 16
    parts = []
    for i in range(2):
        o = rng.normal(size=(b, s, hq, d)).astype(np.float32)
        lse = rng.normal(size=(b, hq, s)).astype(np.float32) * 3
        pm = rng.random((b, hq, s)).astype(np.float32)
        if i == 0:
            lse[0, :, :4] = -np.inf
            o[0, :4] = 0.0
            pm[0, :, :4] = 0.0
        parts.append((o, lse, pm))
    out_j, pm_j = ja_merge([tuple(map(jnp.asarray, p)) for p in parts])
    out_t, pm_t = tfp.merge_attention_partials(
        [tuple(map(torch.from_numpy, p)) for p in parts])
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(pm_j), pm_t.numpy(), atol=1e-6)
    # Every part -inf: zeros, no NaN (the reference would divide 0 by 0).
    dead = [(torch.zeros(1, 2, 1, 4), torch.full((1, 1, 2), -torch.inf),
             torch.zeros(1, 1, 2))] * 2
    out, pm = tfp.merge_attention_partials(dead)
    assert not bool(out.isnan().any() or pm.isnan().any())


ja_merge = jax.jit(jfp.merge_attention_partials)


@pytest.fixture(scope="module")
def runs():
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    jcc = rj.CompressionConfig(num_layers=LAYERS, prompt_frac=0.25)
    tcc = rt.CompressionConfig(num_layers=LAYERS, prompt_frac=0.25)
    tp = tl.init_params(0, tcfg, device="cpu")
    jp = jax_tree(tp)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                            (BATCH, SEQ))
    j_logits, j_state, _ = jl.prefill_compressed_prefix_chunked(
        jp, jnp.asarray(ids), jcfg, jcc, chunk_size=CHUNK, max_decode_len=8)
    j_toks, _ = jax.jit(lambda p, t, s: jl.decode_loop(
        p, t, s, STEPS, jcfg, jcc))(jp, jnp.argmax(j_logits, -1), j_state)
    arms = {}
    for flash in (False, True):
        logits, state, stats = tl.prefill_compressed_prefix_chunked(
            tp, torch.from_numpy(ids), tcfg, tcc, chunk_size=CHUNK,
            max_decode_len=8, use_flash=flash)
        caches = state.caches
        toks, _ = tl.decode_loop(tp, torch.argmax(logits, -1), state, STEPS,
                                 tcfg, tcc)
        arms[flash] = (logits, caches, toks, stats)
    return dict(j_logits=j_logits, j_caches=j_state.caches, j_toks=j_toks,
                arms=arms, tcc=tcc)


@pytest.mark.parametrize("flash", [False, True])
def test_whole_path_matches_jax(runs, flash):
    logits, caches, toks, stats = runs["arms"][flash]
    np.testing.assert_allclose(np.asarray(runs["j_logits"]), logits.numpy(),
                               atol=ATOL_LOGITS)
    assert_caches_match(runs["j_caches"], caches, runs["tcc"])
    np.testing.assert_array_equal(np.asarray(runs["j_toks"]), toks.numpy())
    assert set(stats[0]) == {"seq_len", "kept_tokens", "compression_ratio",
                             "token_memory_savings"}
    with pytest.raises(KeyError):  # as the reference's summary does
        tc.summarize_layer_stats(stats)


def test_query_guided_rejected():
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    ccfg = rt.CompressionConfig(num_layers=LAYERS, importance_source="query")
    with pytest.raises(ValueError, match="prompt"):
        tl.prefill_chunked_compressed_init(1, SEQ, CHUNK, tcfg, ccfg,
                                           device="cpu")
