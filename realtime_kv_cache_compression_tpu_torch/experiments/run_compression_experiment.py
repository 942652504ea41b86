"""Main experiment CLI on the port: baseline vs compressed LongBench
evaluation.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.run_compression_experiment \
        --model tinyllama --baseline --tasks narrativeqa gov_report

The counterpart of the repository's `experiments/run_compression_experiment.py`
(which drives the JAX package): the same hyperparameter surface
(alpha/beta/gamma, theta_h/theta_m, layer-group ratios, bit tiers, tasks,
max_samples, max_new_tokens, output_dir, experiment_name, --baseline),
writing config.json + experiment_summary.json + per-task artifacts, with
error.log (and the exception raised again) on failure. Data: local
LongBench JSONL from --data-dir, else the HF hub where `datasets` and a
network are there, else synthetic planted-answer tasks.

On the port: `--device` (cuda by default) replaces `--platform`, and
`--flash` goes: on a CUDA device the compressed arm runs K1 in prefill
and K2 in decode and the baseline K1 in prefill; --checkpoint loads a
local HF checkpoint with the port's `load_hf_checkpoint`.
`--mesh-data D --mesh-model M` (D·M > 1) runs the evaluation on D·M
ranks, one spawned process each over a gloo group (`parallel.run_ranks`;
on one CUDA device every rank shares it), each on its slice of the
weights (`parallel.shard_params` on a D x M mesh), as the JAX script
shards its params over its mesh; rank 0 writes the artifacts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from .. import (LLAMA2_13B, LLAMA2_7B, TINYLLAMA_1_1B, CompressionConfig,
                tiny_test_model)
from ..eval.longbench import LongBenchEvaluator, ModelRunner
from ..models import llama, weights
from ..parallel import create_mesh, run_ranks, shard_params
from ..utils.data import save_json
from ..utils.memory import MemoryMonitor
from ..utils.tokenizer import load_tokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # Model
    p.add_argument("--model", default="tinyllama",
                   choices=["tiny-test", "tinyllama", "llama2-7b",
                            "llama2-13b"])
    p.add_argument("--checkpoint", default=None,
                   help="local HF checkpoint dir (safetensors) for weights")
    p.add_argument("--layers", type=int, default=None,
                   help="override layer count (smoke tests)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a small run)")
    p.add_argument("--max-length", type=int, default=4096)
    p.add_argument("--max-new-tokens", type=int, default=64)
    # Compression hyperparameters (reference parity)
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--beta", type=float, default=0.3)
    p.add_argument("--gamma", type=float, default=0.3)
    p.add_argument("--theta-h", type=float, default=0.7)
    p.add_argument("--theta-m", type=float, default=0.3)
    p.add_argument("--early-ratio", type=float, default=0.8)
    p.add_argument("--middle-ratio", type=float, default=0.6)
    p.add_argument("--later-ratio", type=float, default=0.4)
    p.add_argument("--high-bits", type=int, default=8)
    p.add_argument("--medium-bits", type=int, default=4)
    p.add_argument("--low-bits", type=int, default=2)
    p.add_argument("--tier-mode", default="quantile",
                   choices=["quantile", "threshold"])
    p.add_argument("--selection-mode", default="topk_prefix",
                   choices=["topk_prefix", "exact_greedy"])
    p.add_argument("--recompute-prefill", action="store_true",
                   help="reference-parity mode: recompute prefill attention "
                        "against compressed K/V")
    # Evaluation
    p.add_argument("--tasks", nargs="+", default=["narrativeqa", "qasper",
                                                  "multifieldqa_en"])
    p.add_argument("--max-samples", type=int, default=10)
    p.add_argument("--eval-batch", type=int, default=1,
                   help="samples per ragged evaluation batch")
    p.add_argument("--data-dir", default=None,
                   help="dir with {task}.jsonl LongBench files")
    p.add_argument("--synthetic-context-words", type=int, default=3000)
    # Execution
    p.add_argument("--baseline", action="store_true",
                   help="also run the uncompressed baseline arm")
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=1)
    # Output
    p.add_argument("--output-dir", default="experiments/results_torch")
    p.add_argument("--experiment-name", default=None)
    return p.parse_args(argv)


def build_configs(args):
    presets = {
        "tiny-test": tiny_test_model(vocab_size=258),
        "tinyllama": TINYLLAMA_1_1B,
        "llama2-7b": LLAMA2_7B,
        "llama2-13b": LLAMA2_13B,
    }
    mcfg = presets[args.model]
    if args.layers:
        mcfg = dataclasses.replace(mcfg, num_layers=args.layers)
    if mcfg.max_position_embeddings < args.max_length + args.max_new_tokens:
        mcfg = dataclasses.replace(
            mcfg,
            max_position_embeddings=args.max_length + args.max_new_tokens)
    ccfg = CompressionConfig(
        alpha=args.alpha, beta=args.beta, gamma=args.gamma,
        theta_h=args.theta_h, theta_m=args.theta_m,
        early_layer_ratio=args.early_ratio,
        middle_layer_ratio=args.middle_ratio,
        later_layer_ratio=args.later_ratio,
        high_precision_bits=args.high_bits,
        medium_precision_bits=args.medium_bits,
        low_precision_bits=args.low_bits,
        num_layers=mcfg.num_layers,
        tier_mode=args.tier_mode,
        selection_mode=args.selection_mode,
        recompute_prefill_attention=args.recompute_prefill,
    )
    return mcfg, ccfg


# The ranks of a mesh run the whole evaluation; this bounds it (and each
# collective).
RANK_TIMEOUT = 4 * 3600.0


def load_params(args, mcfg):
    if args.checkpoint:
        return weights.load_hf_checkpoint(args.checkpoint, mcfg,
                                          device=args.device)
    return llama.init_params(0, mcfg, device=args.device)


def evaluate_arms(args, out_dir, mesh=None):
    """The compressed arm (and with --baseline the baseline arm) over the
    tasks: (results, model_calls) per arm. Artifacts go under out_dir (None:
    none); `mesh` shards the weights over a (data, model) mesh of ranks."""
    device = torch.device(args.device)
    mcfg, ccfg = build_configs(args)
    params = load_params(args, mcfg)
    if mesh is not None:
        params = shard_params(params, mesh, mcfg)
    tokenizer = load_tokenizer(args.checkpoint)
    syn = {"context_words": args.synthetic_context_words}

    results, model_calls = {}, {}
    arms = [("compressed", ccfg)] + ([("baseline", None)]
                                     if args.baseline else [])
    for arm, arm_ccfg in arms:
        mon = MemoryMonitor(device=device)
        mon.start()
        runner = ModelRunner(params, mcfg, arm_ccfg,
                             max_new_tokens=args.max_new_tokens)
        ev = LongBenchEvaluator(
            runner, tokenizer,
            output_dir=os.path.join(out_dir, arm) if out_dir else None,
            max_length=args.max_length, data_dir=args.data_dir,
            synthetic_kwargs=syn)
        results[arm] = ev.evaluate_all_tasks(
            args.tasks, args.max_samples, batch_size=args.eval_batch)
        results[arm]["memory_monitor"] = mon.stop()
        model_calls[arm] = dict(runner.model_calls)
    return results, model_calls


def _rank_arms(rank: int, n: int, group, args, out_dir):
    """One rank of a mesh run: `evaluate_arms` on its slice; rank 0
    writes the artifacts."""
    mesh = create_mesh(args.mesh_data, args.mesh_model)
    return evaluate_arms(args, out_dir if rank == 0 else None, mesh)


def main(argv=None) -> Dict[str, Any]:
    """Runs the experiment; returns {"out_dir", "results" (per arm, as the
    evaluator gives them), "summary", "model_calls" (per arm, the runner's
    own schedule)} for in-process callers. Over a mesh they are rank 0's
    (every rank has the same)."""
    args = parse_args(argv)
    ranks = args.mesh_data * args.mesh_model
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    name = args.experiment_name or f"compression_exp_{time.strftime('%Y%m%d_%H%M%S')}"
    out_dir = os.path.join(args.output_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    save_json(os.path.join(out_dir, "config.json"),
              {**vars(args), "experiment_name": name})

    try:
        if ranks > 1:
            results, model_calls = run_ranks(
                _rank_arms, ranks, args=(args, out_dir),
                timeout=RANK_TIMEOUT)[0]
        else:
            results, model_calls = evaluate_arms(args, out_dir)

        summary = {
            "experiment_name": name,
            "model": args.model,
            "tasks": args.tasks,
            "results": {
                arm: {
                    "overall_quality_score":
                        r["overall"]["overall_quality_score"],
                    "avg_tokens_per_second":
                        r["overall"]["avg_tokens_per_second"],
                    "avg_ttft": r["overall"]["avg_ttft"],
                    **({"memory_savings":
                        r["overall"].get("overall_avg_memory_savings")}
                       if "overall_avg_memory_savings" in r["overall"]
                       else {}),
                } for arm, r in results.items()
            },
            "task_breakdown": {
                arm: {t: v.get("metrics", {}).get("quality")
                      for t, v in r["per_task"].items()}
                for arm, r in results.items()
            },
        }
        save_json(os.path.join(out_dir, "experiment_summary.json"), summary)
        print(json.dumps(summary["results"], indent=2))
        print(f"artifacts: {out_dir}")
    except Exception:
        with open(os.path.join(out_dir, "error.log"), "w") as f:
            f.write(traceback.format_exc())
        raise
    return {"out_dir": out_dir, "results": results, "summary": summary,
            "model_calls": model_calls}


if __name__ == "__main__":
    main()
