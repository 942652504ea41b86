"""The port's expert parallelism vs the JAX package (CPU, float32, gloo
ranks).

A 2-layer MoE `tiny_test_model` (4 experts, top 2, 8 / 4 heads, hidden
128, intermediate 256) with weights from JAX's `init_params` (through
`params_from_jax`); 4 ranks spawned once (`run_ranks`, the rank side
`tests/torch_ranks.expert_parallel_runs`) on a 1x4 and a 2x2 mesh:
- `ep_moe_mlp` on each rank's expert slice against JAX's `ep_moe_mlp` on
  a mesh with the same model axis ((2, 4) and (4, 2) of the 8 CPU
  devices) within 1e-5: at lossless capacity (None) and at capacity
  factor = the model axis, both also within 1e-5 of JAX's
  `moe_mlp_reference`, and at a factor of 0.5, which drops rows: the
  same rows as JAX's (outputs within 1e-5 of JAX's, and away from the
  reference);
- the MoE model's `prefill_compressed` under each mesh (experts on the
  model axis, expert parallel) against JAX's one-device prefill: logits
  within 2e-4 (and of JAX's GSPMD prefill with expert-sharded params on
  its (2, 4) mesh, as `tests/test_moe.py` runs it), kept counts and tier
  membership equal; `decode_loop` tokens equal for 6 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import moe as jmoe
from realtime_kv_cache_compression_tpu.parallel import (create_mesh,
                                                        data_sharding,
                                                        ep_moe_mlp,
                                                        shard_params)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

import torch_ranks
from torch_parity import numpy_tree

LAYERS, B, S, STEPS = 2, 4, 64, 6
DIMS = dict(num_layers=LAYERS, num_experts=4, num_experts_per_tok=2,
            hidden_size=128, intermediate_size=256, num_heads=8,
            num_kv_heads=4)
MESHES = [(1, 4), (2, 2)]
DROP = 0.5
TOL_EP = 1e-5
TOL = 2e-4
# case -> (input index, capacity factor; "m" is the model axis's size)
EP_CASES = {"lossless": (0, None), "factor_m": (0, "m"), "dropping": (1, DROP)}


def _tcfg(jcfg):
    return rt.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})


@pytest.fixture(scope="module")
def setup():
    jcfg = rj.tiny_test_model(**DIMS)
    jp = numpy_tree(jax.jit(lambda k: jl.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((2, 24, 128)).astype(np.float32),
          rng.standard_normal((1, 32, 128)).astype(np.float32)]
    ids = rng.integers(0, jcfg.vocab_size, (B, S))
    params = tl.params_from_jax(jp, device="cpu")
    tcfg = _tcfg(jcfg)
    ccfg = rt.CompressionConfig(num_layers=LAYERS)
    factors = (None, 2.0, 4.0, DROP)
    res = run_ranks(torch_ranks.expert_parallel_runs, 4, args=(
        MESHES, params["layers"][0]["moe"],
        [torch.from_numpy(x) for x in xs], tcfg, factors, params,
        torch.from_numpy(ids), ccfg, STEPS), timeout=240)
    return dict(jcfg=jcfg, jp=jax.tree_util.tree_map(jnp.asarray, jp),
                xs=xs, ids=ids, ranks=res)


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_moe_mlp_matches_jax(setup, case):
    idx, factor = EP_CASES[case]
    jcfg, jp = setup["jcfg"], setup["jp"]
    x = jnp.asarray(setup["xs"][idx])
    ref = np.asarray(jmoe.moe_mlp_reference(jp["layers"][0]["moe"], x, jcfg))
    for data, model in MESHES:
        f = float(model) if factor == "m" else factor
        mesh = create_mesh(8 // model, model)
        moe_s = shard_params(jp, mesh, jcfg)["layers"][0]["moe"]
        want = np.asarray(jax.jit(lambda m, xx: ep_moe_mlp(
            m, xx, jcfg, mesh, capacity_factor=f))(moe_s, x))
        for r, res in enumerate(setup["ranks"]):
            got = res[(data, model, "ep")][(idx, f)].numpy()
            what = f"{case} {data}x{model} rank {r}"
            np.testing.assert_allclose(got, want, atol=TOL_EP, rtol=0,
                                       err_msg=what)
            if factor == DROP:
                assert np.abs(got - ref).max() > 1e-3, what  # rows dropped
            else:
                np.testing.assert_allclose(got, ref, atol=TOL_EP, rtol=0,
                                           err_msg=what)


def test_moe_prefill_under_mesh_matches_jax(setup):
    jcfg, jp = setup["jcfg"], setup["jp"]
    ids = jnp.asarray(setup["ids"])
    ccfg = rj.CompressionConfig(num_layers=LAYERS)
    logits, state, stats = jax.jit(lambda p, i: jl.prefill_compressed(
        p, i, jcfg, ccfg, max_decode_len=STEPS + 4))(jp, ids)
    toks, _ = jax.jit(lambda p, t, s: jl.decode_loop(p, t, s, STEPS, jcfg,
                                                     ccfg))(
        jp, jnp.argmax(logits, -1), state)
    mesh = create_mesh(2, 4)
    dense = dataclasses.replace(jcfg, moe_impl="dense")  # GSPMD's EP form
    gspmd, _, _ = jax.jit(lambda p, i: jl.prefill_compressed(
        p, i, dense, ccfg, max_decode_len=STEPS + 4))(
        shard_params(jp, mesh, jcfg), jax.device_put(ids,
                                                     data_sharding(mesh)))
    kept = {}
    for li, cache in enumerate(state.caches):
        for ti, t in enumerate(cache.tiers):
            pos, valid = np.asarray(t.positions), np.asarray(t.valid)
            for r in range(B):
                kept[(li, ti, r)] = sorted(pos[r][valid[r]].tolist())
    for data, model in MESHES:
        for r, res in enumerate(setup["ranks"]):
            got = res[(data, model, "prefill")]
            what = f"{data}x{model} rank {r}"
            for want in (logits, gspmd):
                np.testing.assert_allclose(got["logits"].numpy(),
                                           np.asarray(want), atol=TOL,
                                           rtol=0, err_msg=what)
            assert got["kept"] == {k: kept[k] for k in got["kept"]}, what
            for li in range(LAYERS):
                np.testing.assert_array_equal(
                    got["stats"][li]["kept_tokens"].numpy(),
                    np.asarray(stats[li]["kept_tokens"]), err_msg=what)
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          np.asarray(toks), err_msg=what)
