"""The port's sequence-parallel prefill vs the JAX package's one-device
functions (CPU, float32, gloo ranks).

A 2-layer `tiny_test_model` (the port's `init_params` weights feed both
packages), B=2 rows of S=128 tokens from a seeded numpy draw. Ranks run
as spawned processes over a gloo group (`parallel.launch.run_ranks`, the
rank side `tests/torch_ranks.seq_parallel_runs`), once per world size (2
and 4) for the whole file; each rank runs `seq_parallel_prefill` in four
arms and decodes 4 greedy tokens from each state (the sharded ones
gathered by `gather_sharded_state` first). JAX's `seq_parallel_prefill`
is not run (its interpret-mode Pallas calls make the JAX package's own
tests slow); the JAX tests hold it to the one-device functions used here:
- replicated compression, prompt-scored: against `prefill_compressed`:
  logits within 1e-4, kept counts equal, each tier's kept positions equal
  as sets (the ring's merged mass differs from the dense mass by float
  association, which may reorder near-tied tokens inside a tier), then
  the greedy tokens equal to `decode_loop`'s; the same on every rank;
- replicated, query-scored ("query", mass pooled over 4 keys) with ragged
  rows (128, 77): against `prefill_compressed(lengths=...)`, the same
  criteria for the prefill;
- fully sharded compression, uniform and ragged (prompt-scored): each
  layer's gathered caches against `compress_layer_kv_chunked(n_chunks=n)`
  over the K/V and masses the ranks compressed: kept positions, validity
  and chunks equal, packed codes within the whole-model limit
  (`torch_parity.assert_caches_match`); the aggregated stats (the same
  on every rank) against the chunked stats: counts equal, the rest
  within 1e-5, but on ragged rows the means that the sharded stats weight
  by valid tokens (and the chunked ones do not): there the mean and std
  against the valid tokens' scores from JAX's `importance_scores`, and
  the six averaged ratios against JAX's per-chunk `compress_layer_kv`
  stats weighted by each chunk's valid tokens (as JAX's
  `_aggregate_sharded_stats` weights them); each rank's shard holds 1/n
  of the slots; then the greedy tokens from the gathered state equal to
  JAX's `decode_loop` over the same state;
- the refusals: S not a multiple of the ranks, a tier with no capacity
  at S/n tokens a rank.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.compression import compressor as jc
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import importance as ji
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

import torch_ranks
from torch_parity import assert_caches_match, jax_tree, state_to_jax

LAYERS, B, S, STEPS = 2, 2, 128, 4
LENGTHS = (128, 77)
TOL_LOGITS = 1e-4
TOL_STATS = 1e-5
INT_STATS = ("seq_len", "kept_tokens", "stored_high", "stored_medium",
             "stored_low", "demoted_count")
# Means the sharded stats weight by each rank's valid tokens on ragged
# rows, and the chunked reference averages over chunks unweighted: the mean
# and std are held to the valid tokens' scores instead, and the averaged
# ratios to the per-chunk stats weighted by valid tokens.
AVERAGED = ("label_high_ratio", "label_medium_ratio", "label_low_ratio",
            "byte_compression_ratio", "byte_memory_savings",
            "budget_utilization")
VALID_WEIGHTED = ("importance_mean", "importance_std") + AVERAGED
QUERY = dict(importance_source="query", query_mass_pool=4)
# arm -> (compression settings, sharded_compression, ragged)
ARMS = {"replicated": ({}, False, False),
        "ragged_query": (QUERY, False, True),
        "sharded": ({}, True, False),
        "ragged_sharded": ({}, True, True)}


@pytest.fixture(scope="module")
def setup():
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    params = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    runs = {name: (rt.CompressionConfig(num_layers=LAYERS, **kw), sharded,
                   torch.tensor(LENGTHS) if ragged else None)
            for name, (kw, sharded, ragged) in ARMS.items()}
    ranks = {n: run_ranks(torch_ranks.seq_parallel_runs, n, args=(
        params, torch.from_numpy(ids), tcfg, runs, STEPS, STEPS + 4),
        timeout=240) for n in (2, 4)}
    return dict(jcfg=rj.tiny_test_model(num_layers=LAYERS), jp=jax_tree(params),
                ids=ids, ranks=ranks)


def _jccfg(arm):
    return rj.CompressionConfig(num_layers=LAYERS, **ARMS[arm][0])


@functools.lru_cache(maxsize=None)
def _jit_decode(settings):
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    ccfg = rj.CompressionConfig(num_layers=LAYERS, **dict(settings))
    return jax.jit(lambda p, t, s: jl.decode_loop(p, t, s, STEPS, jcfg,
                                                  ccfg))


def _decode(setup, arm, first, j_state):
    settings = tuple(sorted(ARMS[arm][0].items()))
    toks, _ = _jit_decode(settings)(setup["jp"], first, j_state)
    return np.concatenate([np.asarray(first)[:, None], np.asarray(toks)], 1)


@pytest.fixture(scope="module")
def one_device(setup):
    """JAX's one-device prefill (and decode) per replicated arm."""
    out = {}
    for arm in ("replicated", "ragged_query"):
        lens = jnp.asarray(LENGTHS) if ARMS[arm][2] else None
        ccfg = _jccfg(arm)
        logits, state, stats = jax.jit(lambda p, i, n: jl.prefill_compressed(
            p, i, setup["jcfg"], ccfg, max_decode_len=STEPS + 4,
            lengths=n))(setup["jp"], jnp.asarray(setup["ids"]), lens)
        toks = (_decode(setup, arm, jnp.argmax(logits, -1), state)
                if arm == "replicated" else None)
        out[arm] = (logits, state, stats, toks)
    return out


_jit_compress = jax.jit(jc.compress_layer_kv, static_argnums=(3, 4, 5),
                        static_argnames=("total_len",))


def _valid_weighted(k, v, pm, layer, ccfg, jcfg, n, tv, plens):
    """The six averaged ratios of n-way sharded compression on ragged
    rows: JAX's one-device `compress_layer_kv` on each chunk, with the
    arguments `compress_layer_kv_chunked` gives it, and each chunk's
    stats weighted by its valid tokens, as `_aggregate_sharded_stats`
    weights each shard's."""
    s_loc = S // n
    mass = jnp.asarray(pm, jnp.float32)
    minmax = (jnp.where(tv, mass, jnp.inf).min(-1, keepdims=True),
              jnp.where(tv, mass, -jnp.inf).max(-1, keepdims=True))
    sums = {key: 0.0 for key in AVERAGED}
    w_tot = 0.0
    for c in range(n):
        sl = slice(c * s_loc, (c + 1) * s_loc)
        _, st = _jit_compress(k[:, sl], v[:, sl], pm[:, sl], layer, ccfg, jcfg,
                    shard_offset=c * s_loc, total_len=S, minmax=minmax,
                    token_valid=tv[:, sl], prompt_lens=plens,
                    chunk_lengths=tv.sum(-1))
        w = np.asarray(tv[:, sl].sum(-1), np.float32)
        for key in AVERAGED:
            sums[key] = sums[key] + np.asarray(st[key]) * w
        w_tot = w_tot + w
    return {key: x / np.maximum(w_tot, 1.0) for key, x in sums.items()}


def _tier_sets(cache):
    return [[set(t.positions[b][t.valid[b]].tolist())
             for b in range(t.positions.shape[0])] for t in cache.tiers]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arm", ["replicated", "ragged_query"])
def test_replicated_prefill_matches_jax(setup, one_device, n, arm):
    j_logits, j_state, j_stats, j_toks = one_device[arm]
    for rank, res in enumerate(setup["ranks"][n]):
        got = res[arm]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(j_logits), atol=TOL_LOGITS,
                                   rtol=0)
        for layer in range(LAYERS):
            np.testing.assert_array_equal(
                got["stats"][layer]["kept_tokens"].numpy(),
                np.asarray(j_stats[layer]["kept_tokens"]))
            assert _tier_sets(got["state"].caches[layer]) == _tier_sets(
                jax.tree_util.tree_map(np.asarray, j_state.caches[layer]))
        if j_toks is not None:
            np.testing.assert_array_equal(got["tokens"].numpy(), j_toks)
    if arm == "replicated":
        for res in setup["ranks"][n]:
            assert res["refused"] == {"length": True, "capacity": True}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arm", ["sharded", "ragged_sharded"])
def test_sharded_compression_matches_jax_chunked(setup, n, arm):
    ranks = setup["ranks"][n]
    ragged = ARMS[arm][2]
    ccfg_j, ccfg_t = _jccfg(arm), rt.CompressionConfig(num_layers=LAYERS)
    tv = (jnp.arange(S)[None] < jnp.asarray(LENGTHS)[:, None]
          if ragged else None)
    plens = (jnp.clip((jnp.asarray(LENGTHS) * ccfg_j.prompt_frac).astype(
        jnp.int32), 1, ccfg_j.prompt_length(S)) if ragged else None)
    for layer in range(LAYERS):
        inputs = [res[arm]["inputs"][layer] for res in ranks]
        k, v, pm = (jnp.asarray(torch.cat([x[f] for x in inputs], 1).numpy())
                    for f in ("k", "v", "pmass"))
        want_cache, want_stats = jax.jit(
            jc.compress_layer_kv_chunked,
            static_argnums=(3, 4, 5, 6))(k, v, pm, layer, ccfg_j,
                                         setup["jcfg"], n, tv, plens)
        for res in ranks:
            assert_caches_match([want_cache], [res[arm]["full"].caches[layer]],
                                ccfg_t)
            for key, want in want_stats.items():
                got = res[arm]["stats"][layer][key].numpy()
                if ragged and key in VALID_WEIGHTED:
                    continue
                if key in INT_STATS:
                    np.testing.assert_array_equal(got, np.asarray(want),
                                                  err_msg=key)
                else:
                    np.testing.assert_allclose(got, np.asarray(want),
                                               atol=TOL_STATS, rtol=TOL_STATS,
                                               err_msg=key)
        if ragged:
            scores = np.asarray(ji.importance_scores(
                pm, layer, S, ccfg_j.prompt_length(S), ccfg_j,
                lengths=jnp.asarray(LENGTHS), prompt_lens=plens))
            valid = np.asarray(tv)
            want = _valid_weighted(k, v, pm, layer, ccfg_j, setup["jcfg"], n,
                                   tv, plens)
            want["importance_mean"] = np.array(
                [scores[b][valid[b]].mean() for b in range(B)])
            want["importance_std"] = np.array(
                [scores[b][valid[b]].std() for b in range(B)])
            for res in ranks:
                for key in VALID_WEIGHTED:
                    np.testing.assert_allclose(
                        res[arm]["stats"][layer][key].numpy(), want[key],
                        atol=TOL_STATS, rtol=TOL_STATS, err_msg=key)
        shard, full = (ranks[0][arm][f].caches[layer].tiers[0]
                       for f in ("state", "full"))
        assert shard.positions.shape[1] * n == full.positions.shape[1]
    full = ranks[0][arm]["full"]
    first = jnp.asarray(ranks[0][arm]["tokens"][:, 0].numpy())
    want = _decode(setup, arm, first, state_to_jax(full))
    for res in ranks:
        np.testing.assert_array_equal(res[arm]["tokens"].numpy(), want)
