"""Ragged (right-padded) batches in the port vs the JAX package (CPU).

Importance with true `lengths` and per-row `prompt_lens` within 1e-6
(float32, same formula; logs may differ in the last bit); selection fed
the JAX scores, so ties cannot flip: kept positions, validity and stats
identical; `compress_layer_kv(token_valid=, prompt_lens=)` with identical
positions, validity and packed bytes, scales within 1e-6 relative (the
jitted reference may fuse the zero point differently by one ulp).

Whole model, 2 layers, lengths (160, 117) in a 160 bucket:
`prefill_compressed(lengths=)` gives identical kept positions, validity and
end positions, packed codes within the whole-model limit
(tests/torch_parity.py), logits within 1e-4 and 8 equal greedy steps; the
uncompressed arm's logits within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu import compression as jc
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import importance as ji
from realtime_kv_cache_compression_tpu.ops import quantization as jq
from realtime_kv_cache_compression_tpu.ops import selection as js
from realtime_kv_cache_compression_tpu_torch import compression as tc
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops import importance as ti
from realtime_kv_cache_compression_tpu_torch.ops import selection as ts
from torch_parity import assert_caches_match, jax_tree

LAYERS, BATCH, PROMPT, STEPS = 2, 2, 160, 8
LENGTHS = (160, 117)
ATOL_SCORES = 1e-6
ATOL_LOGITS = 1e-4

CASES = {
    "default": {},
    "log_bias": dict(position_bias_mode="log", prompt_region_floor=0.0),
    "sinks_window": dict(sink_tokens=3, prompt_region_floor=0.5,
                         recency_window=24),
    "threshold": dict(tier_mode="threshold", theta_h=0.6, theta_m=0.3),
}


def _cfgs(case, num_layers=4):
    kw = CASES[case]
    return (rj.CompressionConfig(num_layers=num_layers, **kw),
            rt.CompressionConfig(num_layers=num_layers, **kw))


def _ragged(seed, b=2, s=96, lengths=(96, 61)):
    mass = np.random.default_rng(seed).random((b, s)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    plens = np.clip((lens * 0.2).astype(np.int32), 1, 19).astype(np.int32)
    valid = np.arange(s)[None, :] < lens[:, None]
    return mass, lens, plens, valid


def _j_scores_labels_sel(mass, lens, plens, valid, layer, cfg):
    """JAX scores, labels and selection, jitted once per (config, layer)."""
    @jax.jit
    def run(m, n, p, v):
        s = m.shape[1]
        scores = ji.importance_scores(m, layer, s, cfg.prompt_length(s), cfg,
                                      lengths=n, prompt_lens=p)
        labels, _ = jq.assign_precision(scores, cfg)
        return scores, labels, js.select_tokens(scores, labels, layer, cfg,
                                                token_valid=v,
                                                prompt_lens=p)
    return run(jnp.asarray(mass), jnp.asarray(lens), jnp.asarray(plens),
               jnp.asarray(valid))


@pytest.mark.parametrize("case,layer", [("default", 0), ("log_bias", 3),
                                        ("sinks_window", 1),
                                        ("threshold", 2)])
def test_ragged_scores_and_selection(case, layer):
    cj, ct = _cfgs(case)
    mass, lens, plens, valid = _ragged(layer)
    scores, labels, sel_j = _j_scores_labels_sel(mass, lens, plens, valid,
                                                 layer, cj)
    s = mass.shape[1]
    st = ti.importance_scores(torch.from_numpy(mass), layer, s,
                              ct.prompt_length(s), ct,
                              lengths=torch.from_numpy(lens),
                              prompt_lens=torch.from_numpy(plens))
    np.testing.assert_allclose(np.asarray(scores), st.numpy(),
                               atol=ATOL_SCORES)
    sel_t = ts.select_tokens(torch.from_numpy(np.array(scores)),
                             torch.from_numpy(np.array(labels)), layer, ct,
                             token_valid=torch.from_numpy(valid),
                             prompt_lens=torch.from_numpy(plens))
    for a, b in zip(sel_j.indices + sel_j.valid, sel_t.indices + sel_t.valid):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(sel_j.kept_mask),
                                  sel_t.kept_mask.numpy())
    assert not sel_t.kept_mask[1, lens[1]:].any()  # padding never kept
    assert set(sel_j.stats) == set(sel_t.stats)
    for key in sel_j.stats:
        np.testing.assert_allclose(np.asarray(sel_j.stats[key]),
                                   sel_t.stats[key].numpy(), rtol=1e-6,
                                   err_msg=key)


_j_compress = jax.jit(jc.compress_layer_kv, static_argnums=(3, 4, 5))


@pytest.mark.parametrize("case,layer", [("default", 0), ("threshold", 3)])
def test_ragged_compress_layer_kv(case, layer):
    mcfg_j = rj.tiny_test_model(num_heads=4, num_kv_heads=2, head_dim=16)
    mcfg_t = rt.tiny_test_model(num_heads=4, num_kv_heads=2, head_dim=16)
    cj, ct = _cfgs(case, num_layers=mcfg_j.num_layers)
    mass, lens, plens, valid = _ragged(10 + layer)
    rng = np.random.default_rng(layer)
    k, v = rng.normal(size=(2, 2, 96, 2, 16)).astype(np.float32)
    cache_j, st_j = _j_compress(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(mass), layer, cj, mcfg_j,
        token_valid=jnp.asarray(valid), prompt_lens=jnp.asarray(plens))
    cache_t, st_t = tc.compress_layer_kv(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mass),
        layer, ct, mcfg_t, token_valid=torch.from_numpy(valid),
        prompt_lens=torch.from_numpy(plens))
    for a, t in zip(cache_j.tiers, cache_t.tiers):
        assert a.chunk == t.chunk
        for f in ("positions", "valid", "k_stored", "v_stored"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(t, f).numpy(), err_msg=f)
        assert not bool((t.positions[1][t.valid[1]] >= lens[1]).any())
        for f in ("k_scale", "k_zp", "v_scale", "v_zp"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                       getattr(t, f).numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f)
    assert set(st_j) == set(st_t)
    for key in st_j:
        np.testing.assert_allclose(np.asarray(st_j[key]), st_t[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def runs():
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    jcc = rj.CompressionConfig(num_layers=LAYERS)
    tcc = rt.CompressionConfig(num_layers=LAYERS)
    tp = tl.init_params(0, tcfg, device="cpu")
    jp = jax_tree(tp)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                            (BATCH, PROMPT))
    lengths = np.asarray(LENGTHS, np.int32)

    @jax.jit
    def run_j(p, i, n):
        logits, state, _ = jl.prefill_compressed(
            p, i, jcfg, jcc, max_decode_len=STEPS + 1, lengths=n)
        toks, _ = jl.decode_loop(p, jnp.argmax(logits, -1), state, STEPS,
                                 jcfg, jcc, use_fused=False)
        unc_logits, _ = jl.prefill_uncompressed(p, i, jcfg, lengths=n)
        return logits, state, toks, unc_logits

    j_logits, j_state, j_toks, j_unc = run_j(jp, jnp.asarray(ids),
                                             jnp.asarray(lengths))
    t_logits, t_state, _ = tl.prefill_compressed(
        tp, torch.from_numpy(ids), tcfg, tcc, max_decode_len=STEPS + 1,
        lengths=torch.from_numpy(lengths))
    t_caches, t_pos = t_state.caches, t_state.position.clone()
    t_toks, _ = tl.decode_loop(tp, torch.argmax(t_logits, -1), t_state,
                               STEPS, tcfg, tcc)
    t_unc, _ = tl.prefill_uncompressed(tp, torch.from_numpy(ids), tcfg,
                                       lengths=torch.from_numpy(lengths))
    return dict(j_logits=j_logits, j_state=j_state, j_toks=j_toks,
                j_unc=j_unc, t_logits=t_logits, t_caches=t_caches,
                t_pos=t_pos, t_toks=t_toks, t_unc=t_unc, tcc=tcc)


def test_ragged_prefill_caches_and_positions(runs):
    np.testing.assert_array_equal(np.asarray(runs["j_state"].position),
                                  runs["t_pos"].numpy())
    np.testing.assert_array_equal(runs["t_pos"].numpy(), LENGTHS)
    assert_caches_match(runs["j_state"].caches, runs["t_caches"],
                        runs["tcc"])
    for cache in runs["t_caches"]:  # padding is never stored
        for t in cache.tiers:
            assert not bool((t.positions[1][t.valid[1]]
                             >= LENGTHS[1]).any())


def test_ragged_logits_and_greedy_tokens(runs):
    np.testing.assert_allclose(np.asarray(runs["j_logits"]),
                               runs["t_logits"].numpy(), atol=ATOL_LOGITS)
    np.testing.assert_array_equal(np.asarray(runs["j_toks"]),
                                  runs["t_toks"].numpy())
    np.testing.assert_allclose(np.asarray(runs["j_unc"]),
                               runs["t_unc"].numpy(), atol=ATOL_LOGITS)
