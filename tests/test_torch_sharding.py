"""The port's tensor and data parallelism vs the JAX package (CPU, float32,
gloo ranks).

A 2-layer `tiny_test_model` (8 / 4 heads, d=16, hidden 128, intermediate
256) with weights from JAX's `init_params` (through `params_from_jax`),
ids of shape (4, 64) from a seeded numpy draw. Without ranks:
- `param_specs` covers the port's tree; every (data, model) slice that
  `shard_params` gives is byte-equal to the matching addressable shard of
  JAX's `shard_params` on the 8-device CPU mesh (2, 4);
- a 258-entry vocab over 4 model ranks replicates, query heads that the
  axis does not divide replicate the attention; fused and quantized trees
  are refused.
Ranks spawned with `run_ranks` (the rank side `tests/torch_ranks.
tensor_parallel_runs`), once per world size (2: a 1x2 mesh; 4: 1x4 and
2x2), every rank held to JAX's one-device functions:
- `prefill_compressed`: logits within 2e-4 (and of JAX's prefill over its
  (2, 4) mesh), `kept_tokens` and the stored counts equal, each tier's
  kept positions equal per row as sets (the order inside a tier may
  differ), the byte stats within 1e-6; `decode_step` logits within 2e-4
  and `decode_loop` tokens equal for 8 steps;
- the same prefill criteria for the chunked prefill query-guided and
  ragged, the compressed-prefix prefill, a model with `qkv_bias` and one
  with tied embeddings and a single kv head (its caches replicated);
- `run_compression_experiment --mesh-model 2` at tiny size: its summary
  and per-sample records equal the one-rank run's but for the timings,
  the kept ratio and byte savings exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.parallel import sharding as js
from realtime_kv_cache_compression_tpu.parallel import create_mesh
from realtime_kv_cache_compression_tpu_torch.experiments import \
    run_compression_experiment as trc
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models.quantized_params import \
    quantize_params
from realtime_kv_cache_compression_tpu_torch.parallel import (
    Mesh, param_specs, run_ranks, shard_layout, shard_params)
from realtime_kv_cache_compression_tpu_torch.utils.data import (
    save_jsonl, synthetic_task_data)

import torch_ranks
from torch_parity import numpy_tree

LAYERS, B, S, STEPS = 2, 4, 64, 8
DIMS = dict(num_layers=LAYERS, num_heads=8, num_kv_heads=4, head_dim=16,
            hidden_size=128, intermediate_size=256)
LENGTHS = (64, 40, 64, 23)
TOL = 2e-4
QUERY = dict(importance_source="query", query_mass_pool=4)
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
# case -> (model variant, compression settings, prefill, ragged, chunk)
CASES = {
    "base": ("base", {}, "prefill_compressed", False, 0),
    "chunked_query": ("base", QUERY, "prefill_compressed_chunked", False, 16),
    "chunked_ragged": ("base", {}, "prefill_compressed_chunked", True, 16),
    "prefix": ("base", {}, "prefill_compressed_prefix_chunked", False, 32),
    "bias": ("bias", {}, "prefill_compressed", False, 0),
    "tied_1kv": ("tied_1kv", {}, "prefill_compressed", False, 0),
}


def _fake_mesh(data, model, d=0, m=0):
    """A Mesh carrying coordinates and no groups (slicing needs no
    collective)."""
    return Mesh(axis_names=("data", "model"),
                shape={"data": data, "model": model},
                coords={"data": d, "model": m},
                groups={"data": None, "model": None})


def _variants(jp_np):
    """Model variants as (JAX config, numpy params): the base model, one
    with q/k/v biases, one with tied embeddings and a single kv head."""
    rng = np.random.default_rng(2)
    base = rj.tiny_test_model(**DIMS)
    bias_layers = [dict(layer, **{n: rng.standard_normal(
        layer[w].shape[1]).astype(np.float32) * 0.1
        for n, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv"))})
        for layer in jp_np["layers"]]
    tied_layers = [dict(layer, wk=layer["wk"][:, :16], wv=layer["wv"][:, :16])
                   for layer in jp_np["layers"]]
    tied = {k: v for k, v in jp_np.items() if k != "lm_head"}
    return {
        "base": (base, jp_np),
        "bias": (dataclasses.replace(base, qkv_bias=True),
                 dict(jp_np, layers=bias_layers)),
        "tied_1kv": (dataclasses.replace(base, tie_word_embeddings=True,
                                         num_kv_heads=1),
                     dict(tied, layers=tied_layers)),
    }


def _tcfg(jcfg):
    return rt.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})


def _jax_run(case, variants, ids):
    name, settings, prefill, ragged, chunk = CASES[case]
    jcfg, jp = variants[name]
    ccfg = rj.CompressionConfig(num_layers=LAYERS, **settings)
    kw = {"lengths": jnp.asarray(LENGTHS)} if ragged else {}
    if chunk:
        kw["chunk_size"] = chunk
    fn = getattr(jl, prefill)
    return jax.jit(lambda p, i: fn(p, i, jcfg, ccfg,
                                   max_decode_len=STEPS + 4, **kw))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(ids))


@pytest.fixture(scope="module")
def setup():
    jcfg = rj.tiny_test_model(**DIMS)
    jp = numpy_tree(jax.jit(lambda k: jl.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    variants = _variants(jp)
    cases = {}
    for case, (name, settings, prefill, ragged, chunk) in CASES.items():
        jc, p = variants[name]
        cases[case] = (tl.params_from_jax(p, device="cpu"), _tcfg(jc),
                       rt.CompressionConfig(num_layers=LAYERS, **settings),
                       prefill, torch.from_numpy(ids),
                       torch.tensor(LENGTHS) if ragged else None, chunk)
    return dict(jcfg=jcfg, jp=jp, ids=ids, variants=variants, cases=cases)


@pytest.fixture(scope="module")
def ranks(setup):
    out = {}
    for n, meshes in MESHES.items():
        for res in run_ranks(torch_ranks.tensor_parallel_runs, n, args=(
                meshes, setup["cases"], STEPS), timeout=240):
            for key, val in res.items():
                out.setdefault(key, []).append(val)
    return out


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's one-device runs of every case, the base decode, and the base
    prefill over the (2, 4) mesh."""
    refs = {case: _jax_run(case, setup["variants"], setup["ids"])
            for case in CASES}
    jcfg, ids = setup["jcfg"], jnp.asarray(setup["ids"])
    ccfg = rj.CompressionConfig(num_layers=LAYERS)
    jp = jax.tree_util.tree_map(jnp.asarray, setup["jp"])
    logits, state, _ = refs["base"]
    step, _ = jax.jit(lambda p, t, s: jl.decode_step(p, t, s, jcfg, ccfg))(
        jp, jnp.full((B,), 7, jnp.int32), state)
    toks, _ = jax.jit(lambda p, t, s: jl.decode_loop(p, t, s, STEPS, jcfg,
                                                     ccfg))(
        jp, jnp.argmax(logits, -1), state)
    mesh = create_mesh(2, 4)
    sharded = js.shard_params(jp, mesh, jcfg)
    with mesh:
        mesh_logits, _, _ = jax.jit(lambda p, i: jl.prefill_compressed(
            p, i, jcfg, ccfg, max_decode_len=STEPS + 4, mesh=mesh))(
            sharded, jax.device_put(ids, js.data_sharding(mesh)))
    return dict(refs=refs, step=np.asarray(step), tokens=np.asarray(toks),
                mesh_logits=np.asarray(mesh_logits))


def _jax_kept(state):
    out = {}
    for li, cache in enumerate(state.caches):
        for ti, t in enumerate(cache.tiers):
            pos, valid = np.asarray(t.positions), np.asarray(t.valid)
            for r in range(pos.shape[0]):
                out[(li, ti, r)] = sorted(pos[r][valid[r]].tolist())
    return out


def _held_to_jax(got, ref, what):
    """A sharded prefill's results on one rank against JAX's one-device
    run: logits, kept counts and tier membership of the rank's rows."""
    logits, state, stats = ref
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(logits),
                               atol=TOL, rtol=0, err_msg=what)
    want = _jax_kept(state)
    assert got["kept"] == {k: want[k] for k in got["kept"]}, what
    for li, st in enumerate(stats):
        for key in ("kept_tokens", "stored_high", "stored_medium",
                    "stored_low", "seq_len"):
            if key in st:
                np.testing.assert_array_equal(
                    got["stats"][li][key].numpy(), np.asarray(st[key]),
                    err_msg=f"{what} layer {li} {key}")
        for key in ("byte_memory_savings", "compression_ratio"):
            if key in st:
                np.testing.assert_allclose(
                    got["stats"][li][key].numpy(), np.asarray(st[key]),
                    atol=1e-6, rtol=0, err_msg=f"{what} layer {li} {key}")


def test_param_specs_and_shards_match_jax(setup):
    """`param_specs` covers the port's tree (and has JAX's layout); every
    (data, model) slice equals JAX's addressable shard at that device,
    byte for byte."""
    jcfg, jp = setup["jcfg"], setup["jp"]
    params = tl.params_from_jax(jp, device="cpu")
    tcfg = _tcfg(jcfg)
    specs = param_specs(tcfg)
    jspecs = js.param_specs(jcfg)
    jax.tree_util.tree_map(
        lambda s, j: None if tuple(j) == tuple(s) else pytest.fail(
            f"spec {s} vs {j}"), specs, jspecs,
        is_leaf=lambda x: isinstance(x, (tuple, P)))
    assert set(specs) == set(params)
    assert all(set(a) == set(b) for a, b in zip(specs["layers"],
                                                params["layers"]))
    mesh = create_mesh(2, 4)
    sharded = js.shard_params(jax.tree_util.tree_map(jnp.asarray, jp), mesh,
                              jcfg)
    leaves = jax.tree_util.tree_leaves_with_path(sharded)
    for d in range(2):
        for m in range(4):
            mine = shard_params(params, _fake_mesh(2, 4, d, m), tcfg)
            for path, leaf in leaves:
                got = mine
                for key in path:
                    got = got[getattr(key, "key", getattr(key, "idx", None))]
                dev = mesh.devices[d, m]
                shard = next(s for s in leaf.addressable_shards
                             if s.device == dev)
                assert got.numpy().tobytes() == np.asarray(
                    shard.data).tobytes(), (d, m, path)


def test_feasibility_and_refusals(setup):
    """A 258-entry vocab over 4 model ranks stays whole (as JAX's
    `_feasible_spec` keeps it); query heads that the axis does not divide
    keep the attention whole; fused and quantized trees raise."""
    cfg = rt.tiny_test_model(vocab_size=258, **DIMS)
    params = tl.init_params(0, cfg, device="cpu")
    sp = shard_params(params, _fake_mesh(1, 4, 0, 3), cfg)
    assert sp["embed"].shape == params["embed"].shape
    assert sp["lm_head"].shape == params["lm_head"].shape
    assert sp["layers"][0]["wq"].shape == (128, 32)
    assert not sp.layout.vocab_split and sp.layout.heads_split
    local = sp.layout.local_config(cfg)
    assert (local.num_heads, local.num_kv_heads, local.intermediate_size,
            local.vocab_size) == (2, 1, 64, 258)
    odd = rt.tiny_test_model(num_heads=6, num_kv_heads=2, head_dim=16,
                             hidden_size=96, intermediate_size=256)
    lay = shard_layout(odd, _fake_mesh(1, 4))
    assert (lay.q_heads, lay.kv_heads, lay.inter, lay.vocab) == (
        (0, 6), (0, 2), (0, 64), (0, 64))
    with pytest.raises(ValueError, match="unfused"):
        shard_params(tl.fuse_params(params), _fake_mesh(1, 2), cfg)
    with pytest.raises(ValueError, match="quantized"):
        shard_params(quantize_params(params, bits=8), _fake_mesh(1, 2), cfg)
    # A rank may fuse its slice: the fused slice keeps its layout.
    assert tl.fuse_params(sp).layout is sp.layout


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_sharded_prefill_and_decode_match_jax(setup, ranks, jax_refs, mesh):
    data, model = map(int, mesh.split("x"))
    results = ranks[(data, model, "base")]
    assert len(results) == data * model
    for r, got in enumerate(results):
        what = f"{mesh} rank {r}"
        _held_to_jax(got, jax_refs["refs"]["base"], what)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   jax_refs["mesh_logits"], atol=TOL, rtol=0,
                                   err_msg=f"{what} vs the JAX mesh")
        np.testing.assert_allclose(got["step_logits"].numpy(),
                                   jax_refs["step"], atol=TOL, rtol=0,
                                   err_msg=f"{what} decode_step")
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      jax_refs["tokens"], err_msg=what)
        assert got["kv_heads"] == 4 // model


def test_prefills_and_families_match_jax(ranks, jax_refs):
    """The chunked prefill query-guided and ragged, the compressed-prefix
    prefill, Qwen2-style biases, and tied embeddings with one kv head
    (replicated on every model rank, caches included), on every mesh."""
    for case in CASES:
        if case == "base":
            continue
        for data, model in [m for ms in MESHES.values() for m in ms]:
            for r, got in enumerate(ranks[(data, model, case)]):
                _held_to_jax(got, jax_refs["refs"][case],
                             f"{case} {data}x{model} rank {r}")
                if case == "tied_1kv":
                    assert got["kv_heads"] == 1


# Keys that differ between two runs whatever they compute (and the name).
_TIMINGS = ("ttft", "decode_time", "tokens_per_second", "memory_monitor",
            "total_time", "elapsed", "experiment_name")


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items()
                if not any(t in k for t in _TIMINGS)}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def test_cli_mesh_model_matches_one_rank(tmp_path):
    """`run_compression_experiment --mesh-model 2` (2 spawned ranks) gives
    the one-rank run's artifacts but for the timings: the answers, the
    kept ratio and the byte savings exactly."""
    data = tmp_path / "data"
    data.mkdir()
    save_jsonl(str(data / "narrativeqa.jsonl"),
               synthetic_task_data("narrativeqa", n_samples=2,
                                   context_words=40))
    common = ["--model", "tiny-test", "--layers", "2", "--device", "cpu",
              "--tasks", "narrativeqa", "--max-samples", "2",
              "--max-length", "256", "--max-new-tokens", "4",
              "--data-dir", str(data), "--output-dir", str(tmp_path)]
    runs = {}
    for name, extra in (("one", []), ("tp", ["--mesh-model", "2"])):
        out = trc.main(common + ["--experiment-name", name] + extra)
        with open(f"{out['out_dir']}/experiment_summary.json") as f:
            runs[name] = (json.load(f), out["results"])
    assert _untimed(runs["tp"][0]) == _untimed(runs["one"][0])
    one, tp = (runs[k][1]["compressed"] for k in ("one", "tp"))
    assert _untimed(tp["per_task"]) == _untimed(one["per_task"])
    assert tp["overall"]["overall_avg_memory_savings"] == one["overall"][
        "overall_avg_memory_savings"]
