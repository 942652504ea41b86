"""The port's ring attention, sharded window mass and sharded importance
vs the JAX package's one-device functions (CPU, float32, gloo ranks).

Ranks run as spawned processes over a gloo group
(`parallel.launch.run_ranks`; the rank side is `tests/torch_ranks.py`),
once per world size (2 and 4) for the whole file. The same numpy inputs
(seeded) feed every rank, which takes its own block of the sequence, and
the ranks' slices, concatenated, are held to:
- `ring_prefill_attention` (the plain pairs: CPU tensors) against JAX's
  dense `prefill_attention_with_prompt_mass`, uniform and with per-row
  `prompt_lens`, with the prompt crossing rank boundaries: output and
  prompt mass within 1e-5;
- `sharded_window_attention_mass` against JAX's `query_attention_mass`
  at pool 0 and at pools 3 and 4 (odd and even, whose halos cross ranks),
  the window spanning ranks: within 1e-5; a halo wider than a rank's
  tokens refused;
- `importance_scores(group=...)` ("both", uniform and ragged) against
  JAX's `importance_scores` over the whole masses: within 1e-6;
- the collectives' contracts (ring and neighbour shifts, the packed
  gather of bf16 and bool tensors) and the meshes (a 2 x 2 and a 1 x 2
  (data, model) grid: coordinates and each axis's group; the sequence
  mesh);
and a failing rank fails the call at once (world size 3), its peers
killed while they wait in a collective.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
from realtime_kv_cache_compression_tpu.ops import attention as ja
from realtime_kv_cache_compression_tpu.ops import importance as ji
from realtime_kv_cache_compression_tpu_torch.parallel import (
    ring_prefill_attention, run_ranks, single_device_mesh)

import torch_ranks

TOL = 1e-5
TOL_SCORES = 1e-6
B, S, HQ, HKV, D = 2, 64, 4, 2, 16
PROMPT_LEN = 24            # crosses the rank boundary at 4 ranks
PROMPT_LENS = (24, 9)
WINDOW = 24                # spans two ranks at 4
POOLS = (0, 3, 4)
SCORE_LENGTHS = (64, 37)


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, S, HQ, D)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    pm = rng.random((B, S)).astype(np.float32)
    qm = (rng.random((B, S)) * 0.1).astype(np.float32)
    return q, k, v, pm, qm


@pytest.fixture(scope="module")
def ranks():
    q, k, v, pm, qm = _inputs()
    t = [torch.from_numpy(x) for x in (q, k, v, pm, qm)]
    args = (*t[:3], PROMPT_LEN, torch.tensor(PROMPT_LENS), WINDOW, POOLS,
            t[3], t[4], torch.tensor(SCORE_LENGTHS))
    return {n: run_ranks(torch_ranks.ring_and_window, n, args=args,
                         timeout=120)
            for n in (2, 4)}


def _cat(results, key, i=None, dim=1):
    return torch.cat([r[key] if i is None else r[key][i] for r in results],
                     dim=dim).numpy()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ragged", [False, True])
def test_ring_attention_matches_jax_dense(ranks, n, ragged):
    q, k, v, _, _ = _inputs()
    want_out, want_pm = ja.prefill_attention_with_prompt_mass(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), PROMPT_LEN,
        prompt_lens=jnp.asarray(PROMPT_LENS) if ragged else None)
    key = "ragged" if ragged else "uniform"
    np.testing.assert_allclose(_cat(ranks[n], key, 0), np.asarray(want_out),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_cat(ranks[n], key, 1), np.asarray(want_pm),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_window_mass_and_importance_match_jax(ranks, n):
    q, k, _, pm, qm = _inputs()
    for pool in POOLS:
        want = ja.query_attention_mass(jnp.asarray(q), jnp.asarray(k),
                                       WINDOW, pool=pool)
        np.testing.assert_allclose(_cat(ranks[n], f"mass_pool{pool}"),
                                   np.asarray(want), atol=TOL, rtol=0,
                                   err_msg=f"pool {pool}")
    assert all(r["halo_refused"] for r in ranks[n])
    cfg = rj.CompressionConfig(num_layers=2, importance_source="both")
    for ragged in (False, True):
        want = ji.importance_scores(
            jnp.asarray(pm), 1, S, cfg.prompt_length(S), cfg,
            lengths=jnp.asarray(SCORE_LENGTHS) if ragged else None,
            query_mass=jnp.asarray(qm))
        got = _cat(ranks[n], "scores_ragged" if ragged else "scores")
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL_SCORES,
                                   rtol=0, err_msg=f"ragged {ragged}")


def test_collectives_and_meshes(ranks):
    for n, r, res in ((n, r, res) for n in ranks
                      for r, res in enumerate(ranks[n])):
        data = 2 if n == 4 else 1
        model = n // data
        shape, coords, groups, model_sum = res["mesh"]
        assert shape == {"data": data, "model": model}
        assert coords == {"data": r // model, "model": r % model}
        assert groups == {"data": (r // model, data) if data > 1 else (0, 1),
                          "model": (r % model, model)}
        first = r // model * model
        assert int(model_sum) == sum(range(first, first + model))
        assert res["seq_mesh"] == (r, n)
        assert float(res["ring_shift"]) == (r - 1) % n
        assert float(res["left"]) == (r - 1 if r > 0 else 0)
        assert float(res["right"]) == (r + 1 if r < n - 1 else 0)
        for src, (vals, flag) in enumerate(res["gathered"]):
            assert vals.dtype == torch.bfloat16
            assert torch.equal(vals, torch.full((2,), src,
                                                dtype=torch.bfloat16))
            assert flag.dtype == torch.bool and bool(flag) == (src % 2 == 0)


def test_one_rank_and_failing_rank():
    """group None is one rank: the ring is the diagonal pair alone, equal
    to the dense attention, and `single_device_mesh` carries no group;
    and a rank that raises fails the call."""
    q, k, v, _, _ = _inputs()
    out, pm = ring_prefill_attention(*(torch.from_numpy(x)
                                       for x in (q, k, v)), PROMPT_LEN, None)
    want_out, want_pm = ja.prefill_attention_with_prompt_mass(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), PROMPT_LEN)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL)
    np.testing.assert_allclose(pm.numpy(), np.asarray(want_pm), atol=TOL)
    assert single_device_mesh().groups == {"data": None, "model": None}
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(torch_ranks.fail_on_rank_one, 3, timeout=120)
