"""PyTorch port's importance, selection and layer compression vs the JAX
package's (CPU).

Importance scores agree within 1e-6 (float32, same formula; the log bias
may differ in the last bit between the two frameworks' log). Selection is
fed the JAX scores and labels, so float ties cannot flip: kept positions,
tiers and validity must be identical. `compress_layer_kv` end to end must
give identical positions, validity and packed bytes, scales and zero points
within 1e-6 relative (the jitted reference may fuse `-min / scale`
differently, one ulp at |zp| ~ 200) and equal stats.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu import compression as jc
from realtime_kv_cache_compression_tpu.ops import importance as ji
from realtime_kv_cache_compression_tpu.ops import quantization as jq
from realtime_kv_cache_compression_tpu.ops import selection as js
from realtime_kv_cache_compression_tpu_torch import compression as tc
from realtime_kv_cache_compression_tpu_torch.ops import importance as ti
from realtime_kv_cache_compression_tpu_torch.ops import selection as ts
from torch_parity import cache_to_torch

ATOL_SCORES = 1e-6

# The JAX side runs jitted with static configs: one compile per (config,
# layer) is far cheaper than first-call eager dispatch of every op.
_j_scores = jax.jit(ji.importance_scores, static_argnums=(1, 2, 3, 4))
_j_compress = jax.jit(jc.compress_layer_kv, static_argnums=(3, 4, 5))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _j_select(mass, layer, cfg, valid=None):
    s = mass.shape[1]
    scores = ji.importance_scores(mass, layer, s, cfg.prompt_length(s), cfg)
    labels, _ = jq.assign_precision(scores, cfg)
    return scores, labels, js.select_tokens(scores, labels, layer, cfg,
                                            token_valid=valid)

CASES = {
    "default": {},
    "log_bias": dict(position_bias_mode="log", prompt_region_floor=0.0),
    "sinks": dict(sink_tokens=3, prompt_region_floor=0.5),
    "threshold": dict(tier_mode="threshold", theta_h=0.6, theta_m=0.3),
    "anchor_16_8_4": "anchor",
}


def _cfgs(case, num_layers=4):
    kw = CASES[case]
    if kw == "anchor":
        return (rj.reference_anchor_config(num_layers=num_layers),
                rt.reference_anchor_config(num_layers=num_layers))
    return (rj.CompressionConfig(num_layers=num_layers, **kw),
            rt.CompressionConfig(num_layers=num_layers, **kw))


def _mass(seed, b=2, s=96):
    return np.random.default_rng(seed).random((b, s)).astype(np.float32)


@pytest.mark.parametrize("layer", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_importance_scores(case, layer):
    cj, ct = _cfgs(case)
    mass = _mass(layer)
    s = mass.shape[1]
    plen = cj.prompt_length(s)
    sj = _j_scores(jnp.asarray(mass), layer, s, plen, cj)
    st = ti.importance_scores(torch.from_numpy(mass), layer, s, plen, ct)
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=ATOL_SCORES)


def test_importance_unported_paths_raise():
    """Sequence sharding (`axis_name`) is not ported. A query source given
    no query mass scores by the prompt mass, as the reference does; the
    query paths themselves are held in tests/test_torch_query_importance.py."""
    ct = rt.CompressionConfig(importance_source="query")
    mass = torch.from_numpy(_mass(0, s=8))
    assert torch.equal(ti.importance_scores(mass, 0, 8, 1, ct),
                       ti.importance_scores(mass, 0, 8, 1,
                                            rt.CompressionConfig()))
    with pytest.raises(NotImplementedError):
        ti.importance_scores(torch.zeros(1, 8), 0, 8, 1, rt.CompressionConfig(),
                             axis_name="seq")


def test_cumulative_scores_match_jax():
    per_layer = np.random.default_rng(5).random((4, 2, 24)).astype(
        np.float32)
    np.testing.assert_allclose(
        ti.cumulative_scores(torch.from_numpy(per_layer)).numpy(),
        np.asarray(ji.cumulative_scores(jnp.asarray(per_layer))), rtol=1e-6)


@pytest.mark.parametrize("layer", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_tokens_on_jax_scores(case, layer):
    cj, ct = _cfgs(case)
    mass = _mass(10 + layer, s=120)
    scores, labels, sel_j = _j_select(jnp.asarray(mass), layer, cj)
    sel_t = ts.select_tokens(torch.from_numpy(np.array(scores)),
                             torch.from_numpy(np.array(labels)), layer, ct)
    for a, b in zip(sel_j.indices, sel_t.indices):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(sel_j.valid, sel_t.valid):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(sel_j.kept_mask),
                                  sel_t.kept_mask.numpy())
    assert set(sel_j.stats) == set(sel_t.stats)
    for key in sel_j.stats:
        np.testing.assert_allclose(np.asarray(sel_j.stats[key]),
                                   sel_t.stats[key].numpy(), rtol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("ragged", [False, True])
def test_selection_unported_paths_raise(ragged):
    """No selection mode is left unported: `exact_greedy` (skip what does
    not fit, keep scanning), refused before, now selects exactly what the
    reference's scan selects on its scores and labels. With 16-bit HIGH
    tokens (cost 2) the budget binds before the token limit, and the scan
    takes a cheaper token where the prefix stops."""
    kw = dict(num_layers=4, selection_mode="exact_greedy",
              tier_mode="threshold", theta_h=0.45, theta_m=0.2,
              high_precision_bits=16, medium_precision_bits=8,
              low_precision_bits=2)
    cj, ct = rj.CompressionConfig(**kw), rt.CompressionConfig(**kw)
    mass = _mass(20, s=64)
    valid = (np.arange(64)[None] < np.array([[64], [41]])) if ragged else None
    scores, labels, sel_j = _j_select(
        jnp.asarray(mass), 1, cj,
        None if valid is None else jnp.asarray(valid))
    sel_t = ts.select_tokens(torch.from_numpy(np.array(scores)),
                             torch.from_numpy(np.array(labels)), 1, ct,
                             token_valid=None if valid is None
                             else torch.from_numpy(valid))
    for a, b in zip(sel_j.indices + sel_j.valid, sel_t.indices + sel_t.valid):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(sel_j.kept_mask),
                                  sel_t.kept_mask.numpy())
    prefix = ts.select_tokens(torch.from_numpy(np.array(scores)),
                              torch.from_numpy(np.array(labels)), 1,
                              rt.CompressionConfig(**{
                                  **kw, "selection_mode": "topk_prefix"}),
                              token_valid=None if valid is None
                              else torch.from_numpy(valid))
    assert bool((sel_t.kept_mask.sum(-1) > prefix.kept_mask.sum(-1)).all())


def test_estimate_compression_ratio_matches_jax():
    for cj, ct in (_cfgs("default"), _cfgs("anchor_16_8_4")):
        for layer in range(4):
            assert (ts.estimate_compression_ratio(layer, 4096, ct)
                    == js.estimate_compression_ratio(layer, 4096, cj))


@pytest.mark.parametrize("case,layers", [
    ("default", (0, 3)), ("log_bias", (1,)), ("sinks", (0,)),
    ("threshold", (2,)), ("anchor_16_8_4", (0,))])
def test_compress_layer_kv_end_to_end(case, layers):
    mcfg_j = rj.tiny_test_model(num_heads=4, num_kv_heads=2, head_dim=16)
    mcfg_t = rt.tiny_test_model(num_heads=4, num_kv_heads=2, head_dim=16)
    cj, ct = _cfgs(case, num_layers=mcfg_j.num_layers)
    rng = np.random.default_rng(sorted(CASES).index(case))
    b, s = 2, 160
    k = rng.normal(size=(b, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(b, s, 2, 16)).astype(np.float32)
    mass = rng.random((b, s)).astype(np.float32)
    stats_j, stats_t = [], []
    for layer in layers:
        cache_j, st_j = _j_compress(
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(mass), layer, cj,
            mcfg_j)
        cache_t, st_t = tc.compress_layer_kv(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mass),
            layer, ct, mcfg_t)
        for a, t in zip(cache_j.tiers, cache_t.tiers):
            assert a.chunk == t.chunk
            for f in ("positions", "valid", "k_stored", "v_stored"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f)).astype(np.float32),
                    getattr(t, f).float().numpy(), err_msg=f)
            for f in ("k_scale", "k_zp", "v_scale", "v_zp"):
                np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                           getattr(t, f).numpy(), rtol=1e-6,
                                           atol=1e-6, err_msg=f)
        assert set(st_j) == set(st_t)
        for key in st_j:
            np.testing.assert_allclose(np.asarray(st_j[key]),
                                       st_t[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        stats_j.append(st_j)
        stats_t.append(st_t)
        # Dequantizing the same (JAX) cache agrees too.
        cache_from_j = cache_to_torch(cache_j)
        for a, t in zip(jc.dequantize_layer_cache(cache_j, cj),
                        tc.dequantize_layer_cache(cache_from_j, ct)):
            np.testing.assert_allclose(np.asarray(a).astype(np.float32),
                                       t.float().numpy(), atol=1e-5)
    assert jc.summarize_layer_stats(stats_j) == \
        tc.summarize_layer_stats(stats_t)


def test_prompt_length_and_per_row_summaries_match_jax():
    """`identify_prompt_length`, and `summarize_layer_stats_per_row` over
    the same (JAX) per-layer stats: equal floats per row."""
    ct, cj = rt.CompressionConfig(num_layers=4), rj.CompressionConfig(
        num_layers=4)
    for s in (1, 7, 160, 4096):
        assert tc.identify_prompt_length(s, ct) == \
            jc.compressor.identify_prompt_length(s, cj)
    rng = np.random.default_rng(6)
    b, s = 2, 160
    k, v = (rng.normal(size=(b, s, 2, 16)).astype(np.float32)
            for _ in range(2))
    mass = rng.random((b, s)).astype(np.float32)
    stats_j = [_j_compress(jnp.asarray(k), jnp.asarray(v), jnp.asarray(mass),
                           layer, cj, rj.tiny_test_model())[1]
               for layer in (0, 3)]
    stats_t = [{key: torch.from_numpy(np.array(val))
                for key, val in st.items()} for st in stats_j]
    want = jc.summarize_layer_stats_per_row(stats_j, b)
    got = tc.summarize_layer_stats_per_row(stats_t, b)
    assert got == want and got[0] != got[1]
    assert tc.summarize_layer_stats_per_row([], b) == [{}, {}]


def test_recent_ring_append_and_drop():
    from realtime_kv_cache_compression_tpu.compression import kv_cache as jk
    from realtime_kv_cache_compression_tpu_torch.compression import (
        kv_cache as tk)
    mj = rj.tiny_test_model(num_kv_heads=2, head_dim=4)
    mt = rt.tiny_test_model(num_kv_heads=2, head_dim=4)
    rng = np.random.default_rng(0)
    rj_, rt_ = jk.init_recent_cache(2, 3, mj), tk.init_recent_cache(2, 3, mt)
    for step in range(5):  # the ring holds 3: the last two appends drop
        kn = rng.normal(size=(2, 1, 2, 4)).astype(np.float32)
        vn = rng.normal(size=(2, 1, 2, 4)).astype(np.float32)
        pos = np.full((2, 1), 10 + step, np.int32)
        rj_ = jk.append_recent(rj_, jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(pos))
        rt_ = tk.append_recent(rt_, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(pos))
        for f in ("k", "v", "positions", "length"):
            np.testing.assert_array_equal(np.asarray(getattr(rj_, f)),
                                          getattr(rt_, f).numpy())
    # Storage bytes at the end-to-end test's default shapes and config (the
    # JAX side reuses that compile).
    mass = np.random.default_rng(1).random((2, 160)).astype(np.float32)
    cache_t, _ = tc.compress_layer_kv(
        torch.zeros(2, 160, 2, 16), torch.zeros(2, 160, 2, 16),
        torch.from_numpy(mass), 0, rt.CompressionConfig(num_layers=4),
        rt.tiny_test_model())
    cache_j, _ = _j_compress(
        jnp.zeros((2, 160, 2, 16)), jnp.zeros((2, 160, 2, 16)),
        jnp.asarray(mass), 0, rj.CompressionConfig(num_layers=4),
        rj.tiny_test_model())
    assert tk.cache_storage_bytes(cache_t) == jk.cache_storage_bytes(cache_j)
    for batch, seq in ((2, 160), (1, 4096)):
        assert (tk.layer_cache_report(cache_t, batch, seq,
                                      rt.tiny_test_model())
                == jk.layer_cache_report(cache_j, batch, seq,
                                         rj.tiny_test_model()))
        assert (tk.uncompressed_kv_bytes(batch, seq, mt, 4)
                == jk.uncompressed_kv_bytes(batch, seq, mj, 4))
