"""Ablation studies over the compression design space, on the port.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.ablation_study \
        --model tinyllama --study component

The counterpart of the repository's `experiments/ablation_study.py` (which
drives the JAX package): the same five studies —
  component     7 configs: zeroed alpha / beta / gamma, uniform precision
                (threshold tiers, theta_h 1.0), uniform propagation,
                all-16-bit tiers
  weights       alpha / beta / gamma grid under alpha + beta + gamma = 1
  thresholds    theta grid with theta_m < theta_h (threshold tiers)
  ratios        early >= middle >= later grid
  bits          bit-tier grid high >= medium >= low
— each config quick-evaluated on two LongBench tasks through the port's
`eval/longbench.py`, with the same artifacts: `{study}_results.json`,
`{study}_results.csv` and `{study}_summary.md`.

On the port: `--device` (cuda by default) replaces `--platform`; on a CUDA
device each evaluation runs K1 in every prefill and K2 in every decode
step, on the CPU their plain versions. The CSV is written with the stdlib
`csv` module, always (the JAX script needs pandas for it). A config whose
evaluation fails is recorded as an `error` row and the sweep goes on, as
in the JAX script; the evaluator's own per-sample and per-task failures
count as the config's failure. After the artifacts are written, the run
exits nonzero if any row carries an error, so a kernel that fails on the
card cannot pass as a low score.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time
from typing import Any, Dict, Optional

import torch

from .. import TINYLLAMA_1_1B, CompressionConfig, tiny_test_model
from ..eval.longbench import LongBenchEvaluator, ModelRunner, recorded_errors
from ..models import llama
from ..utils.data import save_csv, save_json
from ..utils.tokenizer import ByteTokenizer


def quick_eval(mcfg, params, ccfg, tokenizer, tasks, max_samples, max_length,
               max_new_tokens, synthetic_kwargs,
               model_calls: Optional[Dict[str, int]] = None):
    """Evaluate one config; returns quality / savings / perf scalars.

    Raises RuntimeError if the evaluator recorded a failed task or sample.
    `model_calls`, where given, adds up the runner's schedule (prefill
    calls, warm-ups included, and decode steps)."""
    runner = ModelRunner(params, mcfg, ccfg, max_new_tokens=max_new_tokens)
    ev = LongBenchEvaluator(runner, tokenizer, max_length=max_length,
                            synthetic_kwargs=synthetic_kwargs)
    res = ev.evaluate_all_tasks(tasks, max_samples)
    if model_calls is not None:
        for k, v in runner.model_calls.items():
            model_calls[k] = model_calls.get(k, 0) + v
    errors = recorded_errors(res)
    if errors:
        raise RuntimeError(f"the evaluation recorded {len(errors)} failures,"
                           f" the first {errors[0]}")
    o = res["overall"]
    return {
        "quality": o["overall_quality_score"],
        "memory_savings": o.get("overall_avg_memory_savings", 0.0),
        "compression_ratio": o.get("overall_avg_compression_ratio", 1.0),
        "tokens_per_second": o["avg_tokens_per_second"],
        "ttft": o["avg_ttft"],
    }


def component_configs(base):
    """Seven component-ablation variants."""
    rep = dataclasses.replace
    return {
        "full": base,
        "no_attention": rep(base, alpha=0.0, beta=base.beta + base.alpha / 2,
                            gamma=base.gamma + base.alpha / 2),
        "no_position": rep(base, beta=0.0, alpha=base.alpha + base.beta / 2,
                           gamma=base.gamma + base.beta / 2),
        "no_relevance": rep(base, gamma=0.0, alpha=base.alpha + base.gamma / 2,
                            beta=base.beta + base.gamma / 2),
        "uniform_precision": rep(base, theta_h=1.0, theta_m=0.0,
                                 tier_mode="threshold"),
        "uniform_propagation": rep(base, early_layer_ratio=0.6,
                                   middle_layer_ratio=0.6,
                                   later_layer_ratio=0.6),
        "no_quantization": rep(base, high_precision_bits=16,
                               medium_precision_bits=16,
                               low_precision_bits=16),
    }


def weight_grid(base, steps=(0.2, 0.4, 0.6)):
    """alpha + beta + gamma = 1 grid."""
    out = {}
    for a, b in itertools.product(steps, steps):
        g = round(1.0 - a - b, 4)
        if g >= 0.05:
            out[f"a{a}_b{b}_g{g}"] = dataclasses.replace(
                base, alpha=a, beta=b, gamma=g)
    return out


def threshold_grid(base, highs=(0.5, 0.7, 0.9), mids=(0.1, 0.3, 0.5)):
    out = {}
    for th, tm in itertools.product(highs, mids):
        if tm < th:
            out[f"th{th}_tm{tm}"] = dataclasses.replace(
                base, theta_h=th, theta_m=tm, tier_mode="threshold")
    return out


def ratio_grid(base, grid=((0.9, 0.7, 0.5), (0.8, 0.6, 0.4),
                           (0.7, 0.5, 0.3), (0.6, 0.4, 0.25))):
    return {
        f"r{e}_{m}_{l}": dataclasses.replace(
            base, early_layer_ratio=e, middle_layer_ratio=m,
            later_layer_ratio=l)
        for e, m, l in grid
    }


def bits_grid(base, grid=((16, 8, 4), (8, 4, 2), (8, 8, 4), (4, 4, 2))):
    return {
        f"b{h}_{m}_{l}": dataclasses.replace(
            base, high_precision_bits=h, medium_precision_bits=m,
            low_precision_bits=l)
        for h, m, l in grid
    }


STUDIES = {
    "component": component_configs,
    "weights": weight_grid,
    "thresholds": threshold_grid,
    "ratios": ratio_grid,
    "bits": bits_grid,
}


def base_config(num_layers: int) -> CompressionConfig:
    """The config every study varies: the defaults at 8/4/2-bit tiers."""
    return CompressionConfig(num_layers=num_layers, high_precision_bits=8,
                             medium_precision_bits=4, low_precision_bits=2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--study", default="component",
                    choices=list(STUDIES) + ["all"])
    ap.add_argument("--model", default="tiny-test",
                    choices=["tiny-test", "tinyllama"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--tasks", nargs="+", default=["narrativeqa", "qasper"])
    ap.add_argument("--max-samples", type=int, default=10)
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--synthetic-context-words", type=int, default=600)
    ap.add_argument("--output-dir",
                    default="experiments/results_torch/ablation")
    return ap.parse_args(argv)


def write_study(output_dir: str, study: str, rows) -> None:
    """The study's JSON rows, CSV and markdown summary (the best config
    and every evaluated config by quality)."""
    save_json(os.path.join(output_dir, f"{study}_results.json"), rows)
    save_csv(os.path.join(output_dir, f"{study}_results.csv"), rows)
    ok = [r for r in rows if "error" not in r]
    if not ok:
        return
    best = max(ok, key=lambda r: r["quality"])
    lines = [f"# Ablation: {study}", "",
             f"best config: **{best['config']}** "
             f"(quality {best['quality']:.4f}, savings "
             f"{best['memory_savings']:.3f})", "",
             "| config | quality | savings | tok/s |", "|---|---|---|---|"]
    for r in sorted(ok, key=lambda r: -r["quality"]):
        lines.append(f"| {r['config']} | {r['quality']:.4f} | "
                     f"{r['memory_savings']:.3f} | "
                     f"{r['tokens_per_second']:.1f} |")
    with open(os.path.join(output_dir, f"{study}_summary.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> Dict[str, Any]:
    """Runs the studies; returns {"rows": {study: rows}, "model_calls":
    {study: {config: the runner's schedule}}} for in-process callers.
    Exits nonzero (SystemExit) after writing the artifacts if any row
    carries an error."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    mcfg = (tiny_test_model(vocab_size=258) if args.model == "tiny-test"
            else TINYLLAMA_1_1B)
    if args.layers:
        mcfg = dataclasses.replace(mcfg, num_layers=args.layers)
    base = base_config(mcfg.num_layers)
    params = llama.init_params(0, mcfg, device=device)
    tokenizer = ByteTokenizer()
    syn = {"context_words": args.synthetic_context_words}

    studies = list(STUDIES) if args.study == "all" else [args.study]
    os.makedirs(args.output_dir, exist_ok=True)
    all_rows, calls, failed = {}, {}, []
    for study in studies:
        rows = []
        for name, ccfg in STUDIES[study](base).items():
            t0 = time.time()
            calls.setdefault(study, {})[name] = {}
            try:
                m = quick_eval(mcfg, params, ccfg, tokenizer, args.tasks,
                               args.max_samples, args.max_length,
                               args.max_new_tokens, syn,
                               model_calls=calls[study][name])
                rows.append({"config": name, **m,
                             "wall_s": time.time() - t0})
                print(f"[{study}] {name}: quality={m['quality']:.4f} "
                      f"savings={m['memory_savings']:.3f}", flush=True)
            except Exception as e:  # record, keep sweeping; exit 1 below
                rows.append({"config": name, "error": repr(e)})
                failed.append(f"{study}/{name}: {e!r}")
                print(f"[{study}] {name}: FAILED {e!r}", flush=True)
        write_study(args.output_dir, study, rows)
        all_rows[study] = rows
    if failed:
        raise SystemExit(f"ablation_study: {len(failed)} configs failed "
                         f"(artifacts in {args.output_dir}): {failed}")
    return {"rows": all_rows, "model_calls": calls}


if __name__ == "__main__":
    main()
