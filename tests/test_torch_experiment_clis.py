"""The port's chunked_prefix_quality, speculative_benchmark and
serving_benchmark CLIs (CPU, tiny).

The recall models' weights are made by the port's `init_params` and feed
both packages (`torch_parity.jax_tree`); the ids come from the port's
`make_batch` and go to both (the JAX scripts draw theirs with
`jax.random`, so the CLIs' own draws are not compared). Held:
- `chunked_prefix_quality.run_arms` on a 2-layer recall model at T=64
  (chunks of 16): each arm's greedy tokens equal to the JAX script's arm
  computed the JAX script's way (`prefill_uncompressed` + padded
  `decode_loop_uncompressed`, `generate`, and
  `prefill_compressed_prefix_chunked` + `decode_loop`);
- `speculative_benchmark.bench_prompt`: speculative and adaptive tokens
  equal to greedy's (asserted inside), and greedy's equal to JAX's
  `decode_loop` from the same prefill state (`torch_parity.state_to_jax`);
- `serving_benchmark.main` on `tiny-test` completes every request, and
  a malformed `--mesh` raises ValueError;
- the two recall CLIs' and the tuning CLI's `main(argv)` write their
  artifacts (the ablation CLI's: tests/test_torch_ablation.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu_torch import CompressionConfig
from realtime_kv_cache_compression_tpu_torch.experiments import (
    chunked_prefix_quality as tcp)
from realtime_kv_cache_compression_tpu_torch.experiments import (
    hyperparameter_tuning as ttu)
from realtime_kv_cache_compression_tpu_torch.experiments import (
    serving_benchmark as tsb)
from realtime_kv_cache_compression_tpu_torch.experiments import (
    speculative_benchmark as tsp)
from realtime_kv_cache_compression_tpu_torch.experiments.quality_demo import (
    make_batch)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.utils import data as tdata

from torch_parity import jax_tree, state_to_jax

PAYLOAD = 8
BITS = dict(high_precision_bits=8, medium_precision_bits=4,
            low_precision_bits=2)


def _jax_config(mcfg):
    return rj.ModelConfig(**{f: getattr(mcfg, f)
                             for f in ("vocab_size", "hidden_size",
                                       "intermediate_size", "num_layers",
                                       "num_heads", "num_kv_heads",
                                       "head_dim", "max_position_embeddings",
                                       "dtype")})


def _recall_ids(mcfg, batch, filler, seed):
    gen = torch.Generator().manual_seed(seed)
    ids, prompt_len, payload = make_batch(gen, batch, PAYLOAD, filler,
                                          mcfg.vocab_size, "recall")
    return ids[:, :prompt_len], payload


def _jax_arms(params, prompt, mcfg, ccfg, chunk):
    """The JAX script's three arms (experiments/chunked_prefix_quality.py,
    main's batch loop), jitted here as one program (eager, its ops compile
    one by one)."""
    t = prompt.shape[1]
    logits, kv = jl.prefill_uncompressed(params, prompt, mcfg)
    kv = tuple(jnp.pad(a, ((0, 0), (0, 0), (0, PAYLOAD), (0, 0), (0, 0)))
               for a in kv)
    tok = jnp.argmax(logits, -1)
    pos = jnp.full((prompt.shape[0],), t, jnp.int32)
    rest, _, _ = jl.decode_loop_uncompressed(params, tok, kv, pos,
                                             PAYLOAD - 1, mcfg)
    out = {"baseline_fp": jnp.concatenate([tok[:, None], rest], axis=1)}
    out["comp_oneshot"], _ = jl.generate(params, prompt, mcfg, ccfg,
                                         max_new_tokens=PAYLOAD)
    lg, st, _ = jl.prefill_compressed_prefix_chunked(
        params, prompt, mcfg, ccfg, chunk_size=chunk,
        max_decode_len=PAYLOAD + 4)
    tok = jnp.argmax(lg, -1)
    rest, _ = jl.decode_loop(params, tok, st, PAYLOAD - 1, mcfg, ccfg)
    out["comp_prefix"] = jnp.concatenate([tok[:, None], rest], axis=1)
    return out


def test_run_arms_matches_jax():
    mcfg = tcp.model_config(2, 64 + PAYLOAD + 16)
    params = tl.init_params(0, mcfg, device="cpu")
    ccfg = CompressionConfig(num_layers=2, **BITS)
    prompt, _ = _recall_ids(mcfg, 2, 64 - PAYLOAD - 1, 3)
    got = tcp.run_arms(params, prompt, PAYLOAD, mcfg, ccfg, chunk=16)
    want = jax.jit(_jax_arms, static_argnums=(2, 3, 4))(
        jax_tree(params), jnp.asarray(prompt.numpy()), _jax_config(mcfg),
        rj.CompressionConfig(num_layers=2, **BITS), 16)
    assert list(got) == list(tcp.ARMS) == list(want)
    for arm in tcp.ARMS:
        assert got[arm].shape == (2, PAYLOAD)
        np.testing.assert_array_equal(got[arm].numpy(),
                                      np.asarray(want[arm]), err_msg=arm)


def test_speculative_benchmark_matches_greedy_and_jax():
    mcfg = tsp.model_config(2, 128)
    params = tl.init_params(0, mcfg, device="cpu")
    ccfg = CompressionConfig(num_layers=2, **BITS)
    prompt, payload = _recall_ids(mcfg, 2, 40, 7)
    # Speculative and adaptive tokens are asserted equal to greedy's
    # inside; a decode chunk of 4 makes the adaptive arm switch arms.
    row = tsp.bench_prompt(params, prompt, payload, mcfg, ccfg, n_draft=3,
                           reps=1, adaptive=True, chunk=4)
    assert row["tokens"].shape == (2, PAYLOAD)
    assert row["adaptive"]["spec_chunks"] + row["adaptive"][
        "plain_chunks"] == PAYLOAD // 4
    plain = row["adaptive"]["plain_tokens"]
    assert row["model_calls"] == {"prefill": 1,
                                  "decode_steps": 2 * (PAYLOAD + plain)}
    logits, state, _ = tl.prefill_compressed(
        params, prompt, mcfg, ccfg, max_decode_len=PAYLOAD + 3 + 1)
    first = torch.argmax(logits, dim=-1)
    jcfg = _jax_config(mcfg)
    want, _ = jax.jit(jl.decode_loop, static_argnums=(3, 4, 5))(
        jax_tree(params), jnp.asarray(first.numpy()), state_to_jax(state),
        PAYLOAD, jcfg, rj.CompressionConfig(num_layers=2, **BITS))
    np.testing.assert_array_equal(row["tokens"].numpy(), np.asarray(want))


SERVE = ["--device", "cpu", "--model", "tiny-test", "--layers", "2",
         "--context", "128", "--requests", "5", "--new-tokens", "10",
         "--decode-chunk", "4"]


def test_serving_benchmark_completes_every_request():
    run = tsb.main(SERVE)
    s = run["summary"]
    # The warm-up's requests count neither here nor in the summary.
    assert s["completed"] == 5 and len(run["completed"]) == 5
    assert all(r.finished and len(r.tokens) == 10 and r.ttft is not None
               for r in run["completed"].values())
    assert s["total_tokens"] == 50
    assert 0.0 < s["avg_memory_savings"] < 1.0
    # The warm-up admits batches of 1, 2 and 4 (one prefill each); the
    # timed run admits its 5 requests over at least two prefills.
    assert run["model_calls"]["prefill"] >= 3 + 2
    assert run["model_calls"]["chunk_step"] == 0


def test_serving_benchmark_mesh_raises():
    # A mesh run itself is held in tests/test_torch_sharded_serving.py.
    for spec in ("2x", "2y1", "0x2"):
        with pytest.raises(ValueError, match="--mesh"):
            tsb.main(SERVE + ["--mesh", spec])


@pytest.mark.parametrize("cli", ["chunked_prefix_quality",
                                 "speculative_benchmark",
                                 "hyperparameter_tuning"])
def test_cli_writes_artifact(cli, tmp_path, monkeypatch):
    common = ["--device", "cpu", "--steps", "2", "--model-layers", "2",
              "--payload", str(PAYLOAD), "--output-dir", str(tmp_path)]
    if cli == "hyperparameter_tuning":
        monkeypatch.setattr(tdata, "_HUB_UNAVAILABLE", True)  # no network
        run = ttu.main(["--device", "cpu", "--method", "compare",
                        "--trials", "5", "--layers", "2", "--tasks",
                        "narrativeqa", "--max-samples", "1", "--max-length",
                        "256", "--max-new-tokens", "3",
                        "--synthetic-context-words", "24", "--output-dir",
                        str(tmp_path)])
        methods = ["grid", "random", "bayesian", "genetic"]
        for m in methods:
            with open(tmp_path / f"{m}_history.json") as f:
                assert len(json.load(f)) == (6 if m == "genetic" else 5)
        with open(tmp_path / "comparison.csv") as f:
            rows = f.read().splitlines()
        assert rows[0] == "method,best_score,trials,wall_s"
        assert [r.split(",")[0] for r in rows[1:]] == methods
        assert run["gp_fits"]["bayesian"] == 1
    elif cli == "chunked_prefix_quality":
        run = tcp.main(common + ["--contexts", "64,128", "--batch", "4",
                                 "--eval-samples", "4", "--eval-batch", "2"])
        with open(tmp_path / "chunked_prefix_quality.json") as f:
            art = json.load(f)
        for t in (64, 128):
            row = art[f"context{t}"]
            assert row["chunk"] == t // 4
            assert all(row[a]["n"] == 4 for a in tcp.ARMS)
            assert row["prefix_vs_oneshot_acc_delta"] == round(
                row["comp_prefix"]["token_accuracy"]
                - row["comp_oneshot"]["token_accuracy"], 4)
        assert run["model_calls"] == {
            "prefill": 2 * 2 * 2, "prefix_chunks": 2 * 4 * 2,
            "decode_steps": 2 * 2 * 2 * (PAYLOAD - 1)}
    else:
        run = tsp.main(common + ["--fillers", "24,40", "--train-batch", "2",
                                 "--reps", "1", "--params-dir",
                                 str(tmp_path / "params")])
        with open(tmp_path / "speculative_benchmark.json") as f:
            art = json.load(f)
        assert [r["filler"] for r in art["results"]] == [24, 40]
        assert all(r["n_steps"] == PAYLOAD and r["greedy_ms"] > 0
                   for r in art["results"])
        assert (tmp_path / "params" / "recall").exists()
        assert run["model_calls"] == {"prefill": 2,
                                      "decode_steps": 2 * 2 * PAYLOAD}
