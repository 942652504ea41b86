"""Quality-retention demonstration on the port.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.quality_demo \
        --tasks recall --steps 2500 --batch 32 --fillers 48,112,240

Trains a miniature Llama with the port's own train step
(`models/train.py`) on payload-recall tasks — the payload must survive
compressed inference for recall to succeed — then measures accuracy
through the real compressed path across compression strengths, bit tiers
and context lengths. The counterpart of the repository's
`experiments/quality_demo.py` (which drives the JAX package): the same
task layouts, curriculum, SFT mask, arm table and artifact, drawn from
`torch.Generator`s (so other draws than `jax.random`'s). On a CUDA device
the evaluation runs K1 in every prefill and K2 in the compressed decode
(`recall_accuracy(use_flash=False)` runs their plain versions); a failed
evaluation raises.

Task shapes:
  recall    [payload][filler][SEP] -> reproduce the payload.
  multidoc  [m0 doc0 m1 doc1 ...][filler][SEP][m_q] -> reproduce the queried
            doc (the model must retrieve one of several competing payloads
            by its marker).
  needle    [filler_pre][MARK][payload][filler_post][SEP][MARK] -> reproduce
            the payload, which sits at --depths fraction of the filler,
            outside the prompt-region floor and the recency window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import CompressionConfig, reference_anchor_config, tiny_test_model
from ..compression import summarize_layer_stats
from ..config import ModelConfig
from ..models import checkpoint, llama, train
from ..models.quantized_params import quantize_params

SEP = 1
N_DOCS = 4


def make_batch(gen: torch.Generator, batch: int, payload_len: int,
               filler_len: int, vocab: int, task: str, depth: float = 0.5):
    """Returns (full_ids [batch, S] int64, prompt_len, payload [batch,
    payload_len]) drawn from `gen`, on its device.

    `depth` applies to the needle task only: the payload's position as a
    fraction of the filler (0 = head, 1 = tail). Shapes are depth-invariant
    (pre + post = filler_len).
    """
    dev = gen.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def col(value):
        return torch.full((batch, 1), value, dtype=torch.long, device=dev)

    def permutations(n):  # one random permutation of range(n) per row
        return torch.argsort(torch.rand((batch, n), generator=gen,
                                        device=dev), dim=1)

    lo = 2 + N_DOCS  # ids [2, 2+N_DOCS) are doc markers
    if task == "recall":
        payload = randint(lo, vocab - 2, (batch, payload_len))
        filler = randint(lo, vocab - 2, (batch, filler_len))
        full = torch.cat([payload, filler, col(SEP), payload], dim=1)
        return full, payload_len + filler_len + 1, payload
    doc_range = N_DOCS * payload_len
    mid = lo + doc_range
    if mid >= vocab - 2:
        raise ValueError(f"vocab {vocab} too small for {doc_range} distinct "
                         f"{task} tokens")
    if task == "needle":
        # [filler_pre][MARK][payload][filler_post][SEP][MARK][payload]:
        # MARK (the first doc-marker id) is unique in the sequence, payload
        # tokens a per-row permutation of a reserved range, filler from a
        # disjoint range — the needle is found by content alone.
        payload = lo + permutations(doc_range)[:, :payload_len]
        pre = int(round(depth * filler_len))
        post = filler_len - pre
        f_pre = randint(mid, vocab - 2, (batch, pre))
        f_post = randint(mid, vocab - 2, (batch, post))
        full = torch.cat([f_pre, col(2), payload, f_post, col(SEP), col(2),
                          payload], dim=1)
        return full, filler_len + payload_len + 3, payload
    if task != "multidoc":
        raise ValueError(f"unknown task {task!r}")
    # multidoc: marker-tagged docs (a per-row permutation of a reserved
    # range: no token occurs twice in the prompt), filler from a disjoint
    # range, the query by marker after the filler.
    docs = (lo + permutations(doc_range)).reshape(batch, N_DOCS, payload_len)
    filler = randint(mid, vocab - 2, (batch, filler_len))
    qidx = randint(0, N_DOCS, (batch,))
    parts = []
    for d in range(N_DOCS):
        parts += [col(2 + d), docs[:, d]]
    target = docs[torch.arange(batch, device=dev), qidx]
    full = torch.cat(parts + [filler, col(SEP), (2 + qidx)[:, None], target],
                     dim=1)
    return full, N_DOCS * (payload_len + 1) + filler_len + 2, target


def train_recall_model(mcfg: ModelConfig, task: str, steps: int, batch: int,
                       payload_len: int, filler_lens: List[int],
                       lr: float = 3e-3, log_every: int = 200,
                       curriculum_frac: float = 0.4, device="cuda"):
    """Train on the task with filler length cycling over the sweep values
    (so long-context eval is in-distribution); returns the params (no
    longer requiring grad).

    Curriculum: the first `curriculum_frac` of steps use only the SHORTEST
    filler (multidoc's 2-hop retrieval never forms when most steps are at
    lengths where the mechanism does not exist yet). Needle: a fresh
    uniform depth every step, so position is useless as a feature. Only
    the recalled span is supervised (SFT-style): at long fillers an
    unmasked mean is almost all unpredictable filler.
    """
    params = llama.init_params(0, mcfg, device=device)
    optimizer = train.make_optimizer(params, lr=lr, total_steps=steps)
    gen = torch.Generator(device=device).manual_seed(42)
    depth_rng = np.random.RandomState(7)
    filler_lens = sorted(filler_lens)
    warm = int(steps * curriculum_frac)
    loss = None
    for i in range(steps):
        filler = (filler_lens[0] if i < warm
                  else filler_lens[i % len(filler_lens)])
        depth = (float(depth_rng.uniform(0.05, 0.95)) if task == "needle"
                 else 0.5)
        ids, prompt_len, _ = make_batch(gen, batch, payload_len, filler,
                                        mcfg.vocab_size, task, depth=depth)
        tpos = torch.arange(ids.shape[1] - 1, device=ids.device)
        mask = ((tpos >= prompt_len - 1)
                & (tpos < prompt_len - 1 + payload_len)).expand(
                    ids.shape[0], -1)
        loss = train.train_step(params, optimizer, ids, mcfg, loss_mask=mask)
        if i % log_every == 0:
            print(f"  [{task}] step {i}: loss {float(loss):.4f}", flush=True)
    print(f"  [{task}] final loss {float(loss):.4f}", flush=True)
    optimizer.release()
    return params


def eval_ids(mcfg: ModelConfig, task: str, n_eval: int, payload_len: int,
               filler_len: int, seed: int = 123, depth: float = 0.5,
               device="cuda"):
    """The evaluation samples of one row: make_batch from a generator
    seeded with seed + filler_len."""
    gen = torch.Generator(device=device).manual_seed(seed + filler_len)
    return make_batch(gen, n_eval, payload_len, filler_len, mcfg.vocab_size,
                      task, depth=depth)


def recall_accuracy(params, mcfg: ModelConfig,
                    ccfg: Optional[CompressionConfig], task: str,
                    n_eval: int, payload_len: int, filler_len: int,
                    seed: int = 123, use_flash: Optional[bool] = None,
                    eval_batch: Optional[int] = None,
                    depth: float = 0.5,
                    return_tokens: bool = False) -> Dict[str, Any]:
    """Exact-token recall rate through prefill+decode (compressed if ccfg).

    `eval_batch` chunks the eval samples (the baseline's dense
    attention scores scale with batch x S^2). `use_flash` (None: on CUDA
    params) runs K1 in both arms' prefills and K2 in the compressed
    decode. With `return_tokens` the greedy tokens [n_eval, payload_len]
    come back too (on the host)."""
    device = params["final_norm"].device
    ids, prompt_len, payload = eval_ids(mcfg, task, n_eval, payload_len,
                                          filler_len, seed, depth, device)
    prompt = ids[:, :prompt_len]
    eval_batch = eval_batch or n_eval
    outs, summary = [], None
    for i in range(0, n_eval, eval_batch):
        chunk = prompt[i:i + eval_batch]
        if ccfg is not None:
            out, stats = llama.generate(params, chunk, mcfg, ccfg,
                                        max_new_tokens=payload_len,
                                        use_flash=use_flash,
                                        use_fused_decode=use_flash)
            if summary is None:
                summary = summarize_layer_stats(stats)
        else:
            logits, (ks, vs) = llama.prefill_uncompressed(
                params, chunk, mcfg, use_flash=use_flash)
            kv = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0,
                                                   payload_len))
                       for a in (ks, vs))
            tok = torch.argmax(logits, dim=-1)
            pos = torch.full((chunk.shape[0],), chunk.shape[1],
                             dtype=torch.int32, device=device)
            rest, _, _ = llama.decode_loop_uncompressed(
                params, tok, kv, pos, payload_len - 1, mcfg)
            out = torch.cat([tok[:, None], rest], dim=1)
        outs.append(out)
    out = torch.cat(outs, dim=0)
    hit = out == payload
    result = {"token_accuracy": float(hit.float().mean()),
              "exact_match": float(hit.all(dim=1).float().mean()),
              "compression": summary}
    if return_tokens:
        result["tokens"] = out.cpu()
    return result


def model_config(model_width: int, model_layers: int,
                 max_positions: int) -> ModelConfig:
    """The trained mini-Llama: width in whole 32-wide heads (d=32), half as
    many kv heads, vocab 64, float32."""
    n_heads = max(2, model_width // 32)
    return tiny_test_model(vocab_size=64, hidden_size=model_width,
                           intermediate_size=2 * model_width,
                           num_layers=model_layers, num_heads=n_heads,
                           num_kv_heads=max(1, n_heads // 2), head_dim=32,
                           max_position_embeddings=max_positions)


def arm_configs(num_layers: int, payload: int
                ) -> Dict[str, Optional[CompressionConfig]]:
    """The evaluation arms: the uncompressed baseline (None) and each
    compression config, by name."""
    def cc(**kw):
        base = dict(num_layers=num_layers, high_precision_bits=8,
                    medium_precision_bits=4, low_precision_bits=2)
        base.update(kw)
        return CompressionConfig(**base)

    return {
        "baseline_fp": None,
        "conservative": cc(early_layer_ratio=0.9, middle_layer_ratio=0.8,
                           later_layer_ratio=0.7, high_precision_bits=16,
                           medium_precision_bits=8, low_precision_bits=4),
        # Default = recency position bias + prompt-region floor.
        "balanced_8_4_2": cc(),
        # Long-context lever ablation: log position bias, no floor (the
        # regression witness), then each lever alone.
        "balanced_log_bias": cc(position_bias_mode="log",
                                prompt_region_floor=0.0),
        "balanced_recency_only": cc(prompt_region_floor=0.0),
        "balanced_floor_only": cc(position_bias_mode="log"),
        # The reference's committed operating point (~0.45 kept), and the
        # same point with this framework's levers applied.
        "reference_anchor": reference_anchor_config(num_layers=num_layers),
        "anchor_with_fixes": reference_anchor_config(
            num_layers=num_layers, position_bias_mode="recency",
            prompt_region_floor=1.0),
        "aggressive": cc(early_layer_ratio=0.6, middle_layer_ratio=0.4,
                         later_layer_ratio=0.3),
        # Attention-sink anchors: the first 16 / 40 positions pinned to the
        # high tier (40 covers multidoc's doc region).
        "aggressive_sink16": cc(early_layer_ratio=0.6,
                                middle_layer_ratio=0.4,
                                later_layer_ratio=0.3, sink_tokens=16),
        "aggressive_sink40": cc(early_layer_ratio=0.6,
                                middle_layer_ratio=0.4,
                                later_layer_ratio=0.3, sink_tokens=40),
        "very_aggressive_2bit": cc(early_layer_ratio=0.4,
                                   middle_layer_ratio=0.3,
                                   later_layer_ratio=0.25,
                                   high_precision_bits=4,
                                   medium_precision_bits=2,
                                   low_precision_bits=2),
        # Quantization only (retention 1.0).
        "quant_only_8_4_2": cc(early_layer_ratio=1.0, middle_layer_ratio=1.0,
                               later_layer_ratio=1.0),
        "position_only_scores": cc(alpha=0.0, beta=0.85, gamma=0.15),
        "attention_heavy": cc(alpha=0.8, beta=0.1, gamma=0.1),
        # Observation-window (query-guided) importance, mass pooled across
        # the payload span.
        "query_guided": cc(importance_source="query",
                           alpha=0.8, beta=0.1, gamma=0.1,
                           query_mass_pool=2 * payload + 4),
        "query_both": cc(importance_source="both",
                         query_mass_pool=2 * payload + 4),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--tasks", default="recall,multidoc")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--payload", type=int, default=8)
    ap.add_argument("--fillers", default="48,112,240",
                    help="comma list of filler lengths (context sweep)")
    ap.add_argument("--eval-fillers", default=None,
                    help="eval-only filler list (default: same as --fillers)")
    ap.add_argument("--depths", default="0.25,0.5,0.75",
                    help="needle-task payload depths (fractions of the "
                         "filler) — each becomes its own eval row")
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="training lr (multidoc learns best ~1e-3)")
    ap.add_argument("--model-layers", type=int, default=4,
                    help="depth of the trained mini-Llama (multidoc's 2-hop"
                         " retrieval needs >= 6)")
    ap.add_argument("--model-width", type=int, default=128,
                    help="hidden size in whole 32-wide heads")
    ap.add_argument("--eval-batch", type=int, default=None,
                    help="chunk eval samples (long contexts: baseline dense"
                         " scores scale with batch x S^2)")
    ap.add_argument("--eval-samples", type=int, default=64)
    ap.add_argument("--min-baseline", type=float, default=0.95,
                    help="drop a context row (as uninformative) when the "
                         "uncompressed baseline scores below this")
    ap.add_argument("--arms", default=None,
                    help="comma list to restrict the config arms")
    ap.add_argument("--max-positions", type=int, default=None)
    ap.add_argument("--params-dir", default=None,
                    help="reuse trained params: load from PARAMS_DIR/<task> "
                         "if present, else train and save there")
    ap.add_argument("--output-dir",
                    default="experiments/results_torch/quality_demo")
    ap.add_argument("--merge-existing", action="store_true",
                    help="keep rows already in output-dir/quality_demo.json "
                         "(new rows overwrite by key); prior runs' meta "
                         "blocks are kept under meta_prior_runs")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Runs the demo; returns {"results": the artifact's dict, "params":
    {task: trained params}, "train_seconds": {task: s}} (for in-process
    callers)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    fillers = [int(f) for f in args.fillers.split(",")]
    eval_fillers = ([int(f) for f in args.eval_fillers.split(",")]
                    if args.eval_fillers else fillers)
    tasks = args.tasks.split(",")
    max_pos = args.max_positions or (
        max(fillers + eval_fillers)
        + (args.payload + 1) * (N_DOCS + 2) + 16)
    mcfg = model_config(args.model_width, args.model_layers, max_pos)
    arms = arm_configs(mcfg.num_layers, args.payload)
    if args.arms:
        keep = set(args.arms.split(","))
        arms = {k: v for k, v in arms.items() if k in keep}

    results: Dict[str, Any] = {}
    out_path = os.path.join(args.output_dir, "quality_demo.json")
    if args.merge_existing and os.path.exists(out_path):
        with open(out_path) as f:
            old = json.load(f)
        prior = old.pop("meta_prior_runs", [])
        if "meta" in old:
            prior.append(old.pop("meta"))
        results.update(old)
        if prior:
            results["meta_prior_runs"] = prior
        print(f"merged {len(old)} existing rows from {out_path}", flush=True)
    # Every artifact row is reproducible from the artifact alone.
    results["meta"] = {
        "argv": list(sys.argv[1:] if argv is None else argv),
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "kernels": device.type == "cuda",
        "tasks": tasks,
        "train_fillers": fillers,
        "eval_fillers": eval_fillers,
        "steps": args.steps,
        "batch": args.batch,
        "payload": args.payload,
        "lr": args.lr,
        "model_layers": args.model_layers,
        "model_width": args.model_width,
        "eval_samples": args.eval_samples,
        "min_baseline": args.min_baseline,
        "depths": args.depths,
        "date": time.strftime("%Y-%m-%d %H:%M"),
    }

    def dump():
        # Incremental + atomic: a run that dies mid-eval keeps every
        # completed row.
        os.makedirs(args.output_dir, exist_ok=True)
        with open(out_path + ".tmp", "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
        os.replace(out_path + ".tmp", out_path)

    trained, train_seconds = {}, {}
    for task in tasks:
        ckpt = (os.path.join(os.path.abspath(args.params_dir), task)
                if args.params_dir else None)
        if ckpt and os.path.exists(ckpt):
            params = checkpoint.load_checkpoint(
                ckpt, llama.init_params(0, mcfg, device=device), device)
            print(f"loaded {task} params from {ckpt}", flush=True)
        else:
            print(f"training {task} model (fillers {fillers})...", flush=True)
            t0 = time.perf_counter()
            params = train_recall_model(mcfg, task, args.steps, args.batch,
                                        args.payload, fillers, lr=args.lr,
                                        device=device)
            train_seconds[task] = time.perf_counter() - t0
            print(f"trained in {train_seconds[task]:.1f}s", flush=True)
            if ckpt:
                checkpoint.save_checkpoint(ckpt, params)
                print(f"saved {task} params to {ckpt}", flush=True)
        trained[task] = params
        results["meta"].setdefault("train_seconds", {}).update(train_seconds)
        arm_params = {name: params for name in arms}
        task_arms = dict(arms)
        if not args.arms or "balanced_int8_weights" in args.arms:
            task_arms["balanced_int8_weights"] = arm_configs(
                mcfg.num_layers, args.payload)["balanced_8_4_2"]
            arm_params["balanced_int8_weights"] = quantize_params(params)

        depths = ([float(d) for d in args.depths.split(",")]
                  if task == "needle" else [0.5])
        for filler in eval_fillers:
            for depth in depths:
                row_key = f"{task}_filler{filler}" + (
                    f"_d{int(round(depth * 100))}" if task == "needle"
                    else "")
                tag = f"[{task} f={filler}" + (
                    f" d={depth}]" if task == "needle" else "]")
                ctx = {}
                # A compressed-vs-baseline row measures compression only if
                # the baseline can do the task: below --min-baseline the
                # row is recorded under "uninformative_rows".
                if "baseline_fp" in task_arms:
                    base = recall_accuracy(
                        arm_params["baseline_fp"], mcfg, None, task,
                        args.eval_samples, args.payload, filler,
                        eval_batch=args.eval_batch, depth=depth)
                    base.pop("compression", None)
                    print(f"{tag} baseline_fp: "
                          f"acc={base['token_accuracy']:.3f} "
                          f"em={base['exact_match']:.3f}", flush=True)
                    if base["token_accuracy"] < args.min_baseline:
                        print(f"{tag} baseline {base['token_accuracy']:.3f}"
                              f" < {args.min_baseline}: row dropped as "
                              "uninformative (train a deeper/longer model)",
                              flush=True)
                        results.setdefault("uninformative_rows", {})[
                            row_key] = {"baseline_fp": base}
                        dump()
                        continue
                    ctx["baseline_fp"] = base
                for name, ccfg in task_arms.items():
                    if name == "baseline_fp":
                        continue
                    r = recall_accuracy(arm_params[name], mcfg, ccfg, task,
                                        args.eval_samples, args.payload,
                                        filler, eval_batch=args.eval_batch,
                                        depth=depth)
                    comp = r.pop("compression", None)
                    line = (f"{tag} {name}: "
                            f"acc={r['token_accuracy']:.3f} "
                            f"em={r['exact_match']:.3f}")
                    if comp:
                        line += (f" kept={comp['avg_compression_ratio']:.2f}"
                                 f" savings="
                                 f"{comp['avg_memory_savings']:.2f}")
                        r["kept_ratio"] = comp["avg_compression_ratio"]
                        r["memory_savings"] = comp["avg_memory_savings"]
                    ctx[name] = r
                    print(line, flush=True)
                results[row_key] = ctx
                dump()

    dump()
    print(f"wrote {out_path}", flush=True)
    return {"results": results, "params": trained,
            "train_seconds": train_seconds, "mcfg": mcfg}


if __name__ == "__main__":
    main()
