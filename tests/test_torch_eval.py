"""The port's eval harness, benchmark suite and quality demo vs the JAX
package's (CPU, tiny).

One 2-layer float32 `tiny_test_model(vocab_size=258)` (the byte
tokenizer's vocabulary); the port's `init_params` weights feed both
packages (`torch_parity.jax_tree`). JAX's side runs jitted, as its own
tests do, with one module-scoped runner per arm so that each shape
compiles once. Held:
- `ModelRunner.generate`, compressed and baseline, on one ragged batch:
  tokens exact (EOS masking included), compression stats within 1e-6;
- `LongBenchEvaluator` on synthetic tasks of every metric kind
  (F1/EM, ROUGE, accuracy): responses, per-sample metrics, aggregates and
  artifact names exact, compression stats within 1e-6 (timings are
  readings, not compared); ragged batches against the sequential path and
  against JAX's batched path;
- `named_scenarios` field by field; `CompressionBenchmark`'s records on
  injected ids (JAX draws its own with `jax.random`): keys and
  compression stats (1e-6) and the artifact names;
- the quality demo's task layouts, and `recall_accuracy` of a compressed
  arm on given ids (its targets partly the port's own greedy output, so
  the accuracy is not 0) equal to JAX's.
Nothing reaches the network: the loaders see the hub as unavailable.
The evaluators score ROUGE with the pure-Python fallback, the scorer of a
machine without `rouge_score` (the card's); tests/test_torch_eval_utils.py
holds both scorers to JAX's.
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.eval import benchmark_runner as jbr
from realtime_kv_cache_compression_tpu.eval import longbench as jlb
from realtime_kv_cache_compression_tpu.utils import data as jdata
from realtime_kv_cache_compression_tpu_torch.eval import (
    benchmark_runner as tbr)
from realtime_kv_cache_compression_tpu_torch.eval import longbench as tlb
from realtime_kv_cache_compression_tpu_torch.eval import metrics as tm
from realtime_kv_cache_compression_tpu_torch.experiments import (
    quality_demo as tqd)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.utils import data as tdata

from torch_parity import jax_tree

TOL_STATS = 1e-6
NEW_TOKENS = 4
MAX_LENGTH = 256
TASKS = ("narrativeqa", "gov_report", "trec")  # F1/EM, ROUGE, accuracy
SYNTHETIC = {"context_words": 24}
TIMINGS = {"ttft", "tokens_per_second", "avg_ttft", "avg_tokens_per_second"}
SUMMARY_KEYS = ("compression_ratio", "memory_savings",
                "cumulative_compression")


@pytest.fixture(scope="module")
def model():
    cfg = dict(num_layers=2, vocab_size=258)
    tcfg, jcfg = rt.tiny_test_model(**cfg), rj.tiny_test_model(**cfg)
    params = tl.init_params(0, tcfg, device="cpu")
    ccfgs = (rt.CompressionConfig(num_layers=2),
             rj.CompressionConfig(num_layers=2))
    j_params = jax_tree(params)
    j_runners = {
        "compressed": jlb.ModelRunner(j_params, jcfg, ccfgs[1],
                                      max_new_tokens=NEW_TOKENS),
        "baseline": jlb.ModelRunner(j_params, jcfg, None,
                                    max_new_tokens=NEW_TOKENS)}
    return tcfg, jcfg, params, j_params, ccfgs, j_runners


@pytest.fixture
def offline(monkeypatch):
    """Both packages' loaders skip the HF hub (no network attempt), and
    both metrics modules take the ROUGE fallback (`rouge_score` does not
    import)."""
    monkeypatch.setattr(jdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setattr(tdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setitem(sys.modules, "rouge_score", None)
    assert tm.rouge_backend() == "fallback"


def _port_runner(model, arm):
    tcfg, _, params, _, ccfgs, _ = model
    return tlb.ModelRunner(params, tcfg,
                           ccfgs[0] if arm == "compressed" else None,
                           max_new_tokens=NEW_TOKENS)


def _assert_summary_close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_summary_close(got[k], v)
        elif isinstance(v, (list, tuple)):
            assert np.allclose(got[k], v, atol=TOL_STATS, rtol=0), k
        elif v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= TOL_STATS, (k, got[k], v)


def _assert_results_match(got, want):
    """Evaluator results (or records) equal but for timing readings;
    compression stats within TOL_STATS."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k in TIMINGS:
                continue
            if k in SUMMARY_KEYS + ("precision_distribution",
                                    "avg_compression_ratio",
                                    "avg_memory_savings",
                                    "overall_avg_compression_ratio",
                                    "overall_avg_memory_savings"):
                _assert_summary_close({k: got[k]}, {k: v})
            else:
                _assert_results_match(got[k], v)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_results_match(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("arm", ["compressed", "baseline"])
def test_model_runner_matches_jax(model, arm):
    tcfg, _, _, _, _, j_runners = model
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tcfg.vocab_size, (2, MAX_LENGTH)).astype(np.int32)
    lengths = np.array([MAX_LENGTH, 151], np.int32)
    ids[1, 151:] = 0
    runner = _port_runner(model, arm)
    for eos in (None, int(rng.integers(0, 256))):
        got = runner.generate(torch.from_numpy(ids), eos_token_id=eos,
                              lengths=torch.from_numpy(lengths))
        want = j_runners[arm].generate(jnp.asarray(ids), eos_token_id=eos,
                                       lengths=jnp.asarray(lengths))
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))
        assert got["new_tokens"] == want["new_tokens"] == NEW_TOKENS
        assert got["context_length"] == want["context_length"]
        assert ("compression" in got) == (arm == "compressed")
        if arm == "compressed":
            _assert_summary_close(got["compression"], want["compression"])
    # One warm-up for the bucket, then one prefill per call.
    assert runner.model_calls == {"prefill": 3,
                                  "decode_steps": 3 * (NEW_TOKENS - 1)}


def test_longbench_evaluator_matches_jax(model, offline, tmp_path):
    runner = _port_runner(model, "compressed")
    kw = dict(max_length=MAX_LENGTH, synthetic_kwargs=SYNTHETIC)
    ev_t = tlb.LongBenchEvaluator(runner, output_dir=str(tmp_path / "t"),
                                  **kw)
    ev_j = jlb.LongBenchEvaluator(model[5]["compressed"],
                                  output_dir=str(tmp_path / "j"), **kw)
    got = ev_t.evaluate_all_tasks(TASKS, max_samples=1)
    want = ev_j.evaluate_all_tasks(TASKS, max_samples=1)
    _assert_results_match(got, want)
    assert got["overall"]["tasks_evaluated"] == len(TASKS)
    for t in TASKS:
        assert got["per_task"][t]["num_evaluated"] == 1
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    # Reference-parity metrics route the same way, on the same responses
    # and on an exact answer.
    ev_t.reference_parity = ev_j.reference_parity = True
    for t in TASKS:
        for d in got["per_task"][t]["details"]:
            for response in (d["response"], d["answers"][0]):
                assert ev_t._sample_metrics(tdata.LONGBENCH_TASKS[t],
                                            response, d["answers"]) == \
                    ev_j._sample_metrics(jdata.LONGBENCH_TASKS[t], response,
                                         d["answers"])


def test_batched_evaluation_equals_sequential_and_jax(model, offline):
    kw = dict(max_length=MAX_LENGTH, synthetic_kwargs=SYNTHETIC)
    ev_t = tlb.LongBenchEvaluator(_port_runner(model, "compressed"), **kw)
    ev_j = jlb.LongBenchEvaluator(model[5]["compressed"], **kw)
    for task in ("gov_report", "trec"):  # prompts below MAX_LENGTH
        seq = ev_t.evaluate_task(task, max_samples=3)
        bat = ev_t.evaluate_task(task, max_samples=3, batch_size=2)
        assert len({d["context_length"] for d in bat["details"]}) > 1 \
            and max(d["context_length"] for d in bat["details"]) < \
            MAX_LENGTH  # ragged rows, right-padded
        for s, b in zip(seq["details"], bat["details"]):
            assert (s["response"], s["metrics"]) == \
                (b["response"], b["metrics"])
        assert seq["metrics"] == bat["metrics"]
        _assert_results_match(bat, ev_j.evaluate_task(task, max_samples=3,
                                                      batch_size=2))


def test_named_scenarios_match_jax_field_by_field():
    for layers in (2, 22):
        got, want = tbr.named_scenarios(layers), jbr.named_scenarios(layers)
        assert list(got) == list(want)
        for name in want:
            if want[name] is None:
                assert got[name] is None
            else:
                assert dataclasses.asdict(got[name]) == \
                    dataclasses.asdict(want[name]), name


def test_benchmark_suite_records_match_jax(model, tmp_path, monkeypatch):
    tcfg, jcfg, params, j_params, _, _ = model
    ids = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (1, 128)).astype(np.int32)
    configs = ("conservative",)  # the raw 16-bit high tier
    kw = dict(seq_lens=(128,), new_tokens=5)
    bench_t = tbr.CompressionBenchmark(tcfg, params,
                                       output_dir=str(tmp_path / "t"),
                                       device="cpu", **kw)
    bench_j = jbr.CompressionBenchmark(jcfg, j_params,
                                       output_dir=str(tmp_path / "j"), **kw)
    monkeypatch.setattr(bench_t, "_synthetic_ids",
                        lambda s, seed=0: torch.from_numpy(ids[:, :s]))
    monkeypatch.setattr(bench_j, "_synthetic_ids",
                        lambda s, seed=0: jnp.asarray(ids[:, :s]))
    got = bench_t.run_full_benchmark(configs)
    want = bench_j.run_full_benchmark(configs)
    assert list(got) == list(want) == list(configs)
    for name in configs:
        (g,), (w,) = got[name]["per_seq_len"], want[name]["per_seq_len"]
        assert "error" not in g and g.keys() == w.keys()
        assert g["device_mb"] == 0.0  # a CPU run reports no device memory
        for k in ("compression_ratio", "memory_savings"):
            if k in w:
                assert abs(g[k] - w[k]) <= TOL_STATS, (name, k)
        assert got[name]["aggregate"].keys() == want[name]["aggregate"].keys()
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def _jax_quality_demo():
    path = os.path.join(os.path.dirname(__file__), "..", "experiments",
                        "quality_demo.py")
    spec = importlib.util.spec_from_file_location("jax_quality_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(full, prompt_len, payload, task, payload_len, filler, vocab):
    """The structure both packages' batches must share (their draws
    differ): shapes, separators and markers, ranges, the target tail."""
    full, payload = np.asarray(full), np.asarray(payload)
    lo, n_docs = 2 + tqd.N_DOCS, tqd.N_DOCS
    assert payload.shape == (full.shape[0], payload_len)
    assert np.array_equal(full[:, prompt_len:], payload)
    assert (full[:, prompt_len - 1 - (task == "needle" or task == "multidoc")]
            == tqd.SEP).all()
    if task == "recall":
        assert np.array_equal(full[:, :payload_len], payload)
        assert ((full[:, payload_len:prompt_len - 1] >= lo)
                & (full[:, payload_len:prompt_len - 1] < vocab - 2)).all()
    else:
        mid = lo + n_docs * payload_len
        assert ((payload >= lo) & (payload < mid)).all()
        for row in payload:
            assert len(set(row.tolist())) == payload_len
    if task == "needle":
        assert (full[:, prompt_len - 1] == 2).all()
        assert ((full == 2).sum(axis=1) == 2).all()
    if task == "multidoc":
        docs = full[:, :n_docs * (payload_len + 1)].reshape(
            -1, n_docs, payload_len + 1)
        assert (docs[:, :, 0] == 2 + np.arange(n_docs)).all()
        q = full[:, prompt_len - 1] - 2
        assert np.array_equal(docs[np.arange(len(q)), q, 1:], payload)
        f = full[:, n_docs * (payload_len + 1):prompt_len - 2]
        assert f.shape[1] == filler and (f >= mid).all()
    return full.shape, prompt_len


def test_make_batch_layouts_match_jax():
    jqd = _jax_quality_demo()
    vocab, payload_len, filler = 64, 8, 30
    gen = torch.Generator().manual_seed(0)
    for i, (task, depth) in enumerate((("recall", 0.5), ("needle", 0.25),
                                       ("multidoc", 0.5))):
        got = tqd.make_batch(gen, 5, payload_len, filler, vocab, task,
                             depth=depth)
        want = jqd.make_batch(jax.random.PRNGKey(i), 5, payload_len,
                              filler, vocab, task, depth=depth)
        args = (task, payload_len, filler, vocab)
        assert _layout(*got, *args) == _layout(*want, *args)
        if task == "needle":
            pre = int(round(depth * filler))
            for full in (got[0], want[0]):
                assert (np.asarray(full)[:, pre] == 2).all()


def test_recall_accuracy_on_given_ids_matches_jax(monkeypatch):
    jqd = _jax_quality_demo()
    tcfg = tqd.model_config(64, 2, 64)
    jcfg = rj.tiny_test_model(  # the JAX demo's 2-layer, 64-wide model
        vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=2, num_kv_heads=1, head_dim=32, max_position_embeddings=64)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        rt.tiny_test_model(**{k: getattr(jcfg, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "head_dim",
            "max_position_embeddings")}))
    params = tl.init_params(0, tcfg, device="cpu")
    j_params = jax_tree(params)
    payload_len, filler, n = 4, 16, 4
    full, prompt_len, _ = tqd.make_batch(torch.Generator().manual_seed(3), n,
                                         payload_len, filler,
                                         tcfg.vocab_size, "recall")

    def given(target):
        """Both demos evaluate `full`'s prompts against `target`."""
        monkeypatch.setattr(tqd, "make_batch",
                            lambda *a, **k: (full, prompt_len, target))
        monkeypatch.setattr(jqd, "make_batch", lambda *a, **k: (
            jnp.asarray(full.numpy()), prompt_len,
            jnp.asarray(target.numpy())))

    # The compressed arm (the baseline's path is the runner's, above).
    ccfg = tqd.arm_configs(2, payload_len)["balanced_8_4_2"]
    given(full[:, prompt_len:])
    own = tqd.recall_accuracy(params, tcfg, ccfg, "recall", n, payload_len,
                              filler, return_tokens=True)["tokens"]
    target = full[:, prompt_len:].clone()
    target[:2] = own[:2]  # rows the model gets right by construction
    target[1, -1] = (own[1, -1] + 1) % tcfg.vocab_size
    given(target)
    got = tqd.recall_accuracy(params, tcfg, ccfg, "recall", n, payload_len,
                              filler)
    want = jqd.recall_accuracy(
        j_params, jcfg, rj.CompressionConfig(**dataclasses.asdict(ccfg)),
        "recall", n, payload_len, filler)
    assert got["token_accuracy"] == want["token_accuracy"] >= \
        (2 * payload_len - 1) / (n * payload_len)
    assert got["exact_match"] == want["exact_match"] >= 1 / n
    _assert_summary_close(got["compression"], want["compression"])
