"""The port's sharded serving engine, `ServingEngine(mesh=)`, vs the JAX
package's one-device engine and the port's one-rank engine (CPU, float32,
gloo ranks).

JAX's sharded-serving test shape (`tests/test_serving.py:114`): a 2-layer
`tiny_test_model` with 8 / 4 heads, d=16, hidden 128, intermediate 256,
weights from JAX's `init_params` (through `params_from_jax`); 2 slots, a
64-token bucket, budgets of 6 tokens and decode chunks of 4, over JAX's
four 64-token prompts plus a shorter one and a repeat of the first. Four
ranks are spawned once (the rank side `tests/torch_ranks.
sharded_serving_runs`), and every rank runs every engine:
- one-shot admission on a (2, 2) and a (1, 4) mesh: every request's tokens
  and stop reasons equal to JAX's engine (synchronous admission, whose
  batch-wide byte savings do not depend on timing) and to the port's
  one-rank engine, its prefill stats within 1e-6 of the one-rank
  engine's; each rank holds its data block of the slots (one row on
  (2, 2)) and admits synchronously;
- chunked admission (`prefill_chunk=16`, K1 mode (b)'s path over a rank's
  heads) on (2, 2) against the port's one-rank chunked engine, whose
  tokens equal JAX's chunked engine's (synchronous admission);
- a sampled engine with a prefix cache on (2, 2) against the one-rank
  engine with the same seed: the same tokens and prefix hits on every
  rank.
Also: 3 slots over 2 data ranks raise ValueError (JAX `:143`), and
`serving_benchmark --mesh 2x2 --device cpu` completes every request with
the one-rank run's tokens.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.serving import engine as je
from realtime_kv_cache_compression_tpu_torch.experiments import \
    serving_benchmark as tsb
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops.sampling import \
    SamplingParams
from realtime_kv_cache_compression_tpu_torch.parallel import Mesh, run_ranks
from realtime_kv_cache_compression_tpu_torch.serving import engine as te

import torch_ranks
from torch_parity import numpy_tree

DIMS = dict(num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
            hidden_size=128, intermediate_size=256)
ENGINE = dict(num_slots=2, context_len=64, max_new_tokens=9, decode_chunk=4)
SAMPLED = dict(ENGINE, sampling=SamplingParams(temperature=0.8, top_k=20),
               seed=3, prefix_cache_size=4)
RUNS = {"oneshot_2x2": ((2, 2), ENGINE), "oneshot_1x4": ((1, 4), ENGINE),
        "chunked_2x2": ((2, 2), dict(ENGINE, prefill_chunk=16)),
        "sampled_2x2": ((2, 2), SAMPLED)}
TOL_STATS = 1e-6
SERVE = ["--device", "cpu", "--model", "tiny-test", "--layers", "2",
         "--context", "128", "--requests", "5", "--new-tokens", "10",
         "--decode-chunk", "4"]


def prompt(seed, n=64):  # JAX tests/test_serving.py's prompts
    rng = np.random.default_rng(seed)
    return rng.integers(1, 250, size=n).tolist()


PROMPTS = [(prompt(i), 6) for i in range(4)] + [(prompt(7, 29), 5),
                                                (prompt(0), 6)]


@pytest.fixture(scope="module")
def parts():
    jcfg = rj.tiny_test_model(**DIMS)
    jp = jax.jit(lambda k: jl.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tcfg = rt.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg,
                tp=tl.params_from_jax(numpy_tree(jp), device="cpu"),
                tccfg=rt.CompressionConfig(num_layers=2))


def _serve(eng):
    rids = [eng.submit(p, max_new_tokens=m) for p, m in PROMPTS]
    done = eng.run()
    return {"tokens": [done[r].tokens for r in rids],
            "stop": [done[r].stop_reason for r in rids],
            "stats": [done[r].prefill_stats for r in rids],
            "summary": eng.summary()}


@pytest.fixture(scope="module")
def one_rank(parts):
    return {name: _serve(te.ServingEngine(parts["tp"], parts["tcfg"],
                                          parts["tccfg"], **kw))
            for name, kw in (("oneshot", ENGINE),
                             ("chunked", dict(ENGINE, prefill_chunk=16)),
                             ("sampled", SAMPLED))}


@pytest.fixture(scope="module")
def ranks(parts):
    return run_ranks(torch_ranks.sharded_serving_runs, 4, args=(
        parts["tp"], parts["tcfg"], parts["tccfg"], RUNS, PROMPTS),
        timeout=240)


def _same_as(got, ref):
    assert got["tokens"] == ref["tokens"]
    assert got["stop"] == ref["stop"]
    for g, r in zip(got["stats"], ref["stats"]):
        assert g.keys() == r.keys()
        for key, value in r.items():
            if isinstance(value, dict):
                for k2, v2 in value.items():
                    assert g[key][k2] == pytest.approx(v2, abs=TOL_STATS)
            else:
                assert g[key] == pytest.approx(value, abs=TOL_STATS), key


def test_sharded_engine_matches_jax_and_one_rank(parts, one_rank, ranks):
    jeng = je.ServingEngine(parts["jp"], parts["jcfg"],
                            rj.CompressionConfig(num_layers=2),
                            async_admission=False, **ENGINE)
    jtokens = _serve(jeng)["tokens"]
    assert one_rank["oneshot"]["tokens"] == jtokens
    for name in ("oneshot_2x2", "oneshot_1x4"):
        data = RUNS[name][0][0]
        for r in ranks:
            _same_as(r[name], one_rank["oneshot"])
            assert r[name]["rows"] == ENGINE["num_slots"] // data
            assert not r[name]["async"]
            assert r[name]["summary"]["completed"] == len(PROMPTS)


def test_chunked_admission_over_mesh(parts, one_rank, ranks):
    jeng = je.ServingEngine(parts["jp"], parts["jcfg"],
                            rj.CompressionConfig(num_layers=2),
                            async_admission=False,
                            **dict(ENGINE, prefill_chunk=16))
    assert one_rank["chunked"]["tokens"] == _serve(jeng)["tokens"]
    for r in ranks:
        _same_as(r["chunked_2x2"], one_rank["chunked"])
        assert r["chunked_2x2"]["calls"]["chunk_step"] > 0
        assert r["chunked_2x2"]["calls"]["prefill"] == 0


def test_sampled_engine_with_prefix_cache_over_mesh(one_rank, ranks):
    ref = one_rank["sampled"]
    assert ref["summary"]["prefix_cache"]["hits"] == 1
    for r in ranks:
        _same_as(r["sampled_2x2"], ref)
        assert r["sampled_2x2"]["summary"]["prefix_cache"] == \
            ref["summary"]["prefix_cache"]


def test_slots_must_divide_the_data_axis(parts):
    mesh = Mesh(axis_names=("data", "model"), shape={"data": 2, "model": 1},
                coords={"data": 0, "model": 0},
                groups={"data": None, "model": None})
    with pytest.raises(ValueError, match="data-axis"):
        te.ServingEngine(parts["tp"], parts["tcfg"], parts["tccfg"],
                         num_slots=3, mesh=mesh)


def test_serving_benchmark_over_a_mesh():
    one = tsb.main(SERVE)
    run = tsb.main(SERVE + ["--mesh", "2x2"])
    assert run["engine"] is None
    assert run["summary"]["completed"] == 5
    assert run["summary"]["total_tokens"] == one["summary"]["total_tokens"]
    assert {rid: r.tokens for rid, r in run["completed"].items()} == \
        {rid: r.tokens for rid, r in one["completed"].items()}
    assert run["summary"]["avg_memory_savings"] == pytest.approx(
        one["summary"]["avg_memory_savings"], abs=TOL_STATS)
