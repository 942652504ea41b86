"""The port's eval and utility modules vs the JAX package's (CPU, no model).

Text metrics, the LongBench task registry and data, JSON persistence,
footprint estimators, timing and memory helpers: inputs drawn with numpy
from a seed go through both packages, and every result must be equal (the
metrics are the same Python arithmetic in the same order, so exactly;
footprints in bytes, exactly). ROUGE is held both through `rouge_score`
and through the pure-Python fallback that runs where `rouge_score` is
missing (as on the card machine), forced by hiding the package. Nothing
here reaches the network: `load_task_data` is held to its local and
synthetic branches with the hub marked unavailable in both packages. And
every module of the port, with `chip_smoke.py`, imports in a process
where importing JAX or the JAX package raises.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.eval import metrics as jm
from realtime_kv_cache_compression_tpu.utils import data as jdata
from realtime_kv_cache_compression_tpu.utils import memory as jmem
from realtime_kv_cache_compression_tpu.utils import timing as jtiming
from realtime_kv_cache_compression_tpu_torch.eval import metrics as tm
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models import (
    quantized_params as tq)
from realtime_kv_cache_compression_tpu_torch.utils import data as tdata
from realtime_kv_cache_compression_tpu_torch.utils import memory as tmem
from realtime_kv_cache_compression_tpu_torch.utils import profiling as tprof
from realtime_kv_cache_compression_tpu_torch.utils import timing as ttiming

from torch_parity import jax_tree

WORDS = ("the a an cat cats running runs ran model models cache caching "
         "key value secret code 42 jumped jumps quick brown fox").split()
PUNCT = ("", ",", ".", "!", "?", "'s", ";")


@pytest.fixture
def offline(monkeypatch):
    """Both packages' loaders skip the HF hub (no network attempt)."""
    monkeypatch.setattr(jdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setattr(tdata, "_HUB_UNAVAILABLE", True)


def _texts(rng, n):
    """n random sentences: words with punctuation, case and articles."""
    out = []
    for _ in range(n):
        words = [str(rng.choice(WORDS)) + str(rng.choice(PUNCT))
                 for _ in range(int(rng.integers(0, 12)))]
        words = [w.upper() if rng.random() < 0.2 else w for w in words]
        out.append(" ".join(words))
    return out


@pytest.mark.parametrize("backend", ["rouge_score", "fallback"])
def test_text_metrics_match_jax(backend, monkeypatch):
    if backend == "fallback":
        monkeypatch.setitem(sys.modules, "rouge_score", None)
    assert tm.rouge_backend() == backend
    rng = np.random.default_rng(0)
    preds, truths = _texts(rng, 40), _texts(rng, 40)
    preds[:3] = ["", "the", truths[2]]
    truths[:2] = ["", ""]
    for p, t in zip(preds, truths):
        for parity in (False, True):
            assert tm.normalize_text(p, parity) == jm.normalize_text(p, parity)
            assert tm.f1_score(p, t, reference_parity=parity) == \
                jm.f1_score(p, t, reference_parity=parity)
            assert tm.exact_match(p, t, reference_parity=parity) == \
                jm.exact_match(p, t, reference_parity=parity)
        assert tm.accuracy_score(p, t) == jm.accuracy_score(p, t)
        assert tm.rouge_scores(p, t) == jm.rouge_scores(p, t)
        assert tm.bleu_score(p, t) == jm.bleu_score(p, t)
    for w in WORDS + ["caresses", "ponies", "relational", "hopping"]:
        assert tm.porter_stem(w) == jm.porter_stem(w)
    answers = truths[5:9]
    for p in preds[:10]:
        assert tm.best_over_ground_truths(tm.f1_score, p, answers) == \
            jm.best_over_ground_truths(jm.f1_score, p, answers)
    per_sample = [{"f1": float(rng.random()), "em": float(rng.random() < .5)}
                  for _ in range(7)] + [{"f1": 0.25}]
    assert tm.aggregate_metrics(per_sample) == \
        jm.aggregate_metrics(per_sample)
    assert tm.aggregate_metrics([]) == jm.aggregate_metrics([])
    acc_t, acc_j = tm.CompressionMetrics(), jm.CompressionMetrics()
    for i in range(4):
        o, c = float(rng.integers(100, 200)), float(rng.integers(10, 100))
        acc_t.record_layer(i, o, c, bits=8)
        acc_j.record_layer(i, o, c, bits=8)
    assert acc_t.overall() == acc_j.overall()
    for n, s in ((10, 0.5), (0, 0.0), (3, 2.0)):
        assert tm.tokens_per_second(n, s) == jm.tokens_per_second(n, s)
        assert tm.time_per_token_ms(n, s) == jm.time_per_token_ms(n, s)
    assert tm.quality_adjusted_savings(0.7, 0.9, 0.05) == \
        jm.quality_adjusted_savings(0.7, 0.9, 0.05)


def test_task_registry_prompts_and_synthetic_data_match_jax():
    as_tuple = dataclasses.astuple
    assert {k: as_tuple(v) for k, v in tdata.LONGBENCH_TASKS.items()} == \
        {k: as_tuple(v) for k, v in jdata.LONGBENCH_TASKS.items()}
    assert tdata.CORE_TASKS == jdata.CORE_TASKS
    assert tdata.PROMPT_TEMPLATES == jdata.PROMPT_TEMPLATES
    rng = np.random.default_rng(1)
    for name in tdata.LONGBENCH_TASKS:
        # Within one process both packages salt hash(task_name) alike.
        kw = dict(n_samples=3, context_words=int(rng.integers(20, 200)),
                  seed=int(rng.integers(0, 100)))
        rows = tdata.synthetic_task_data(name, **kw)
        assert rows == jdata.synthetic_task_data(name, **kw)
        task_t, task_j = tdata.LONGBENCH_TASKS[name], \
            jdata.LONGBENCH_TASKS[name]
        for row in rows + [{"context": "c", "input": "q",
                            "answers": "one answer"}, {}]:
            assert tdata.format_prompt(task_t, row) == \
                jdata.format_prompt(task_j, row)
            assert tdata.extract_answers(row, task_t) == \
                jdata.extract_answers(row, task_j)
    assert tdata.synthetic_context(50, 3, "planted fact here") == \
        jdata.synthetic_context(50, 3, "planted fact here")
    ids = rng.integers(0, 300, 97).tolist()
    for limit in (10, 96, 97, 200):
        assert tdata.truncate_middle(ids, limit) == \
            jdata.truncate_middle(ids, limit)


def test_jsonl_round_trip_and_offline_loading_match_jax(tmp_path, offline):
    rng = np.random.default_rng(2)
    rows = [{"context": " ".join(_texts(rng, 3)), "input": "q?",
             "answers": [str(rng.integers(0, 999))], "i": i}
            for i in range(5)]
    tdata.save_jsonl(str(tmp_path / "t" / "narrativeqa.jsonl"), rows)
    jdata.save_jsonl(str(tmp_path / "j" / "narrativeqa.jsonl"), rows)
    assert (tmp_path / "t" / "narrativeqa.jsonl").read_bytes() == \
        (tmp_path / "j" / "narrativeqa.jsonl").read_bytes()
    for d in ("t", "j"):
        for n in (None, 2):
            got = tdata.load_task_data("narrativeqa", str(tmp_path / d), n)
            assert got == jdata.load_task_data("narrativeqa",
                                               str(tmp_path / d), n)
            assert got == rows[:n or len(rows)]
    obj = {"a": 1.5, "b": [1, "x"], "c": {"d": None}}
    tdata.save_json(str(tmp_path / "t.json"), obj)
    jdata.save_json(str(tmp_path / "j.json"), obj)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text()) == obj
    # No local file and no hub: the synthetic branch, or an error.
    kw = dict(synthetic_kwargs={"context_words": 40})
    assert tdata.load_task_data("gov_report", str(tmp_path), 3, **kw) == \
        jdata.load_task_data("gov_report", str(tmp_path), 3, **kw)
    with pytest.raises(FileNotFoundError):
        tdata.load_task_data("trec", None, 2, allow_synthetic=False)


def test_model_footprint_and_kv_cache_bytes_match_jax():
    cfg = rt.tiny_test_model(num_layers=2)
    params = tl.init_params(0, cfg, device="cpu")
    for tree in (params, tq.quantize_params(params),
                 tq.quantize_params(params, act_quant=True),
                 tq.quantize_params(params, bits=4, group_size=32),
                 tl.fuse_params(params)):
        assert tmem.model_footprint_mb(tree) == \
            jmem.model_footprint_mb(jax_tree(tree))
    rng = np.random.default_rng(3)
    for _ in range(5):
        args = [int(x) for x in rng.integers(1, 64, 5)]
        for nbytes in (1, 2, 4):
            assert tmem.kv_cache_bytes(*args, bytes_per_el=nbytes) == \
                jmem.kv_cache_bytes(*args, bytes_per_el=nbytes)


def test_timing_memory_and_profiling_helpers(tmp_path, monkeypatch):
    # `timed` on a scripted clock: the same walls give the same result.
    ticks = np.random.default_rng(4).uniform(0.0, 0.5, 12).cumsum().tolist()
    for mod in (ttiming, jtiming):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        calls = []
        got = mod.timed(lambda: calls.append(1) or len(calls), 0.01, reps=6)
        if mod is ttiming:
            port = got
        else:
            assert port == got and calls == [1] * 6
    monkeypatch.undo()
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    assert ttiming.readback(x) == 15.0
    assert ttiming.measure_rtt(reps=3, device="cpu") > 0
    assert ttiming.median([3.0, 1.0, 2.0, 5.0]) == 3.0
    assert ttiming.spread([2.0, 1.0, 3.0]).startswith(
        "median 2.000 (min 1.000, max 3.000")
    assert tmem.device_memory_stats("cpu") == {
        "device_mb": 0.0, "device_peak_mb": 0.0, "device_limit_mb": 0.0}
    mon = tmem.MemoryMonitor(interval_s=0.01, device="cpu")
    mon.start()
    summary = mon.stop()
    assert summary["num_samples"] >= 2 and summary["peak_rss_mb"] > 0
    assert summary["peak_device_mb"] == 0.0
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("marked_region"):
            torch.ones(4).sum()
    assert any(e.key == "marked_region" for e in prof.key_averages())
    (trace,) = (tmp_path / "trace").iterdir()
    assert "marked_region" in trace.read_text()


def test_port_and_chip_smoke_import_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "realtime_kv_cache_compression_tpu")
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"imports {name}")

        sys.meta_path.insert(0, Block())
        import realtime_kv_cache_compression_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        print(len(names))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 40  # every module was walked
