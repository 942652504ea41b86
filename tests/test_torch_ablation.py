"""The port's ablation_study CLI against the repository's JAX script
(`experiments/ablation_study.py`, loaded by path), on the CPU.

Held: the five studies' configs field by field; `quick_eval` on one
2-layer float32 `tiny_test_model(vocab_size=258)` whose weights, made by
the port's `init_params`, feed both packages (`torch_parity.jax_tree`):
its quality exactly, savings and kept ratio within 1e-6, and behind them
the evaluators' responses (the greedy tokens, decoded) exactly and their
per-sample compression stats within 1e-6; the CSV laid out as pandas lays
it, and the markdown summary, with pandas made unimportable; a failing
config recorded as an error row, the sweep going on, and the run exiting
nonzero after writing its artifacts. The loaders see the HF hub as
unavailable (no network attempt) and ROUGE takes the pure-Python
fallback, as on the card.
"""

import csv
import dataclasses
import importlib.util
import json
import os
import sys

import pandas as pd
import pytest

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.eval import longbench as jlb
from realtime_kv_cache_compression_tpu.utils import data as jdata
from realtime_kv_cache_compression_tpu.utils import tokenizer as jtok
from realtime_kv_cache_compression_tpu_torch.eval import longbench as tlb
from realtime_kv_cache_compression_tpu_torch.experiments import (
    ablation_study as tab)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.utils import data as tdata
from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
    ByteTokenizer)

from torch_parity import jax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_STATS = 1e-6
STATS = ("compression_ratio", "memory_savings", "cumulative_compression")
SMALL = ["--device", "cpu", "--layers", "2", "--tasks", "narrativeqa",
         "--max-samples", "1", "--max-length", "256", "--max-new-tokens",
         "3", "--synthetic-context-words", "24"]


@pytest.fixture(scope="module")
def jab():
    """The JAX script, loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_ablation_study", os.path.join(ROOT, "experiments",
                                           "ablation_study.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setattr(jdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setattr(tdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setitem(sys.modules, "rouge_score", None)


@pytest.mark.parametrize("study", list(tab.STUDIES))
def test_generators_match_jax(jab, study):
    base = dict(num_layers=4, high_precision_bits=8,
                medium_precision_bits=4, low_precision_bits=2)
    assert list(jab.STUDIES) == list(tab.STUDIES)
    want = jab.STUDIES[study](rj.CompressionConfig(**base))
    got = tab.STUDIES[study](tab.base_config(4))
    assert tab.base_config(4) == rt.CompressionConfig(**base)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name]), name


def _capture(monkeypatch, module, into):
    """Records what each `evaluate_all_tasks` call of `module`'s evaluator
    returns."""
    original = module.LongBenchEvaluator.evaluate_all_tasks

    def recording(self, *args, **kw):
        into.append(original(self, *args, **kw))
        return into[-1]

    monkeypatch.setattr(module.LongBenchEvaluator, "evaluate_all_tasks",
                        recording)


def test_quick_eval_matches_jax(jab, offline, monkeypatch):
    shape = dict(vocab_size=258, num_layers=2)
    tcfg, jcfg = rt.tiny_test_model(**shape), rj.tiny_test_model(**shape)
    params = tl.init_params(0, tcfg, device="cpu")
    base = dict(num_layers=2, high_precision_bits=8,
                medium_precision_bits=4, low_precision_bits=2)
    args = (["narrativeqa"], 2, 256, 4, {"context_words": 24})
    results = {"port": [], "jax": []}
    _capture(monkeypatch, tlb, results["port"])
    _capture(monkeypatch, jlb, results["jax"])
    calls = {}
    got = tab.quick_eval(tcfg, params, rt.CompressionConfig(**base),
                         ByteTokenizer(), *args, model_calls=calls)
    want = jab.quick_eval(jcfg, jax_tree(params),
                          rj.CompressionConfig(**base),
                          jtok.ByteTokenizer(), *args)
    assert got.keys() == want.keys()
    assert got["quality"] == want["quality"]
    for k in ("memory_savings", "compression_ratio"):
        assert abs(got[k] - want[k]) <= TOL_STATS, k
    # Two ragged samples of one bucket: a warm-up and two timed prefills.
    assert calls == {"prefill": 3, "decode_steps": 3 * 3}
    (t_res,), (j_res,) = results["port"], results["jax"]
    t_det = t_res["per_task"]["narrativeqa"]["details"]
    j_det = j_res["per_task"]["narrativeqa"]["details"]
    assert len(t_det) == len(j_det) == 2
    for t, j in zip(t_det, j_det):
        assert t["response"] == j["response"]
        assert t["metrics"] == j["metrics"]
        assert t["precision_distribution"].keys() == \
            j["precision_distribution"].keys()
        for k in STATS:
            assert abs(t[k] - j[k]) <= TOL_STATS, k


def _rows(out_dir, study):
    with open(os.path.join(out_dir, f"{study}_results.json")) as f:
        return json.load(f)


def test_main_writes_csv_and_markdown_without_pandas(tmp_path, offline,
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    run = tab.main(SMALL + ["--study", "bits", "--output-dir",
                            str(tmp_path)])
    rows = _rows(tmp_path, "bits")
    assert [r["config"] for r in rows] == ["b16_8_4", "b8_4_2", "b8_8_4",
                                           "b4_4_2"]
    assert run["rows"]["bits"] == rows
    assert all("error" not in r for r in rows)
    # One runner per config: a warm-up and a timed prefill of one sample.
    assert all(c == {"prefill": 2, "decode_steps": 4}
               for c in run["model_calls"]["bits"].values())
    monkeypatch.undo()
    with open(tmp_path / "bits_results.csv") as f:
        text = f.read()
    assert text == pd.DataFrame(rows).to_csv(index=False)
    with open(tmp_path / "bits_results.csv") as f:
        assert list(csv.DictReader(f))[0]["config"] == "b16_8_4"
    with open(tmp_path / "bits_summary.md") as f:
        md = f.read().splitlines()
    best = max(rows, key=lambda r: r["quality"])
    assert md[0] == "# Ablation: bits"
    assert md[2].startswith(f"best config: **{best['config']}**")
    assert len(md) == 6 + len(rows)


def test_main_exits_nonzero_when_a_row_errors(tmp_path, offline,
                                              monkeypatch):
    real = tl.decode_loop

    def decode_loop(*args, **kw):  # fails under one config only
        if args[5].high_precision_bits == 4:
            raise RuntimeError("decode kernel failed")
        return real(*args, **kw)

    monkeypatch.setattr(tl, "decode_loop", decode_loop)
    with pytest.raises(SystemExit) as exc:
        tab.main(SMALL + ["--study", "bits", "--output-dir", str(tmp_path)])
    assert exc.value.code not in (0, None)
    assert "b4_4_2" in str(exc.value.code)
    rows = _rows(tmp_path, "bits")
    assert [r["config"] for r in rows if "error" in r] == ["b4_4_2"]
    assert "decode kernel failed" in rows[-1]["error"]
    with open(tmp_path / "bits_results.csv") as f:
        assert next(csv.reader(f))[-1] == "error"
    with open(tmp_path / "bits_summary.md") as f:
        assert len(f.read().splitlines()) == 6 + 3
