"""Quality cost of the compressed-prefix chunked prefill, on the port.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.chunked_prefix_quality \
        --contexts 256,1024,4096 --steps 2400

The compressed-prefix path makes each later chunk attend over the
quantized, selected pools of the earlier chunks
(`llama.prefill_compressed_prefix_chunked`), which is what lets
compression cut TTFT. This measures its token-accuracy cost on the recall
task (the mini Llama trained by the port's trainer, quality_demo's
machinery) against the one-shot compressed prefill and the uncompressed
baseline, at several context lengths. The counterpart of the repository's
`experiments/chunked_prefix_quality.py` (which drives the JAX package):
the same model, arms, running means and artifact
(`chunked_prefix_quality.json` with `prefix_vs_oneshot_acc_delta`); the
samples come from `torch.Generator`s seeded 123 + filler, so other draws
than `jax.random`'s.

Arms per context length T (the recall prompt is T tokens: filler =
T - payload - 1), `run_arms`:
  baseline_fp     uncompressed prefill + decode over the dense cache
  comp_oneshot    one-shot compressed prefill + decode (`llama.generate`)
  comp_prefix     compressed-prefix chunked prefill (chunk = T/4) + decode

On the port: `--device` (cuda by default) replaces `--platform`, and
`--flash` goes: on a CUDA device the one-shot prefills run K1 mode (a),
the prefix path K1 mode (d) over the earlier chunks' pools and the
diagonal pair over its own chunk, and both compressed decodes K2 (over
the chunk-packed tiers on the prefix path); on the CPU their plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

import torch

from .. import CompressionConfig, tiny_test_model
from ..models import checkpoint, llama
from .quality_demo import make_batch, train_recall_model

ARMS = ("baseline_fp", "comp_oneshot", "comp_prefix")


def model_config(layers: int, max_pos: int):
    """The recall model: hidden 128, 4 / 2 heads of 32, vocab 64,
    float32."""
    return tiny_test_model(vocab_size=64, hidden_size=128,
                           intermediate_size=256, num_layers=layers,
                           num_heads=4, num_kv_heads=2, head_dim=32,
                           max_position_embeddings=max_pos)


def run_arms(params, prompt, payload_len: int, mcfg, ccfg, chunk: int
             ) -> Dict[str, torch.Tensor]:
    """Each arm's greedy tokens [B, payload_len] for prompt [B, T], by arm
    name (the kernels on CUDA inputs)."""
    b, t = prompt.shape
    # baseline_fp: the dense [L, B, S, H, D] cache padded along S to
    # T + payload_len; decode writes each step's K/V at its position.
    logits, kv = llama.prefill_uncompressed(params, prompt, mcfg)
    kv = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, payload_len))
               for a in kv)
    tok = torch.argmax(logits, dim=-1)
    pos = torch.full((b,), t, dtype=torch.int32, device=prompt.device)
    rest, _, _ = llama.decode_loop_uncompressed(params, tok, kv, pos,
                                                payload_len - 1, mcfg)
    out = {"baseline_fp": torch.cat([tok[:, None], rest], dim=1)}
    out["comp_oneshot"], _ = llama.generate(params, prompt, mcfg, ccfg,
                                            max_new_tokens=payload_len)
    logits, state, _ = llama.prefill_compressed_prefix_chunked(
        params, prompt, mcfg, ccfg, chunk_size=chunk,
        max_decode_len=payload_len + 4)
    tok = torch.argmax(logits, dim=-1)
    rest, _ = llama.decode_loop(params, tok, state, payload_len - 1, mcfg,
                                ccfg)
    out["comp_prefix"] = torch.cat([tok[:, None], rest], dim=1)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--contexts", default="256,1024",
                    help="comma list of prompt lengths T (each a multiple "
                    "of 16; chunk = T/4)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--payload", type=int, default=8)
    ap.add_argument("--model-layers", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-samples", type=int, default=32)
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--params-dir", default=None,
                    help="load the trained model from PARAMS_DIR/recall if "
                    "present, else train and save there")
    ap.add_argument("--output-dir",
                    default="experiments/results_torch/chunked_prefix_quality")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Runs the measurement; returns {"results": the artifact's dict,
    "params", "mcfg", "ccfg", "model_calls": the run's one-shot prefills,
    prefix chunk steps and compressed decode steps} for in-process
    callers."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    contexts = [int(c) for c in args.contexts.split(",")]
    for t in contexts:
        if t % 16:
            raise SystemExit(f"context {t} must be a multiple of 16")
    fillers = [t - args.payload - 1 for t in contexts]  # recall prompt len
    mcfg = model_config(args.model_layers,
                        max(contexts) + args.payload + 16)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=8,
                             medium_precision_bits=4,
                             low_precision_bits=2)

    ckpt = (os.path.join(os.path.abspath(args.params_dir), "recall")
            if args.params_dir else None)
    if ckpt and os.path.exists(ckpt):
        params = checkpoint.load_checkpoint(
            ckpt, llama.init_params(0, mcfg, device=device), device)
        print(f"loaded params from {ckpt}", flush=True)
    else:
        params = train_recall_model(mcfg, "recall", args.steps, args.batch,
                                    args.payload, fillers, lr=args.lr,
                                    device=device)
        if ckpt:
            checkpoint.save_checkpoint(ckpt, params)
            print(f"saved params to {ckpt}", flush=True)

    results: Dict[str, Any] = {"meta": {
        "argv": list(sys.argv[1:] if argv is None else argv),
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "contexts": contexts, "model_layers": args.model_layers,
        "steps": args.steps, "date": time.strftime("%Y-%m-%d %H:%M")}}
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, "chunked_prefix_quality.json")
    # The run's model calls: one-shot prefills (K1 mode (a) once per layer
    # on the card), prefix chunk steps (K1 mode (d) and the diagonal pair
    # once per layer) and compressed decode steps (K2 once per layer).
    calls = {"prefill": 0, "prefix_chunks": 0, "decode_steps": 0}

    for t, filler in zip(contexts, fillers):
        chunk = t // 4
        gen = torch.Generator(device=device).manual_seed(123 + filler)
        ids, prompt_len, payload = make_batch(
            gen, args.eval_samples, args.payload, filler, mcfg.vocab_size,
            "recall")
        if prompt_len != t:
            raise AssertionError(f"prompt length {prompt_len} != {t}")
        prompt = ids[:, :prompt_len]
        row: Dict[str, Any] = {"chunk": chunk}
        for i in range(0, args.eval_samples, args.eval_batch):
            pb = prompt[i:i + args.eval_batch]
            plb = payload[i:i + args.eval_batch]
            calls["prefill"] += 2
            calls["prefix_chunks"] += t // chunk
            calls["decode_steps"] += 2 * (args.payload - 1)
            for name, o in run_arms(params, pb, args.payload, mcfg, ccfg,
                                    chunk).items():
                hit = (o == plb).float()
                acc = float(hit.mean())
                em = float(hit.all(dim=1).float().mean())
                agg = row.setdefault(name, {"token_accuracy": 0.0,
                                            "exact_match": 0.0, "n": 0})
                n_new = agg["n"] + pb.shape[0]
                agg["token_accuracy"] = (agg["token_accuracy"] * agg["n"]
                                         + acc * pb.shape[0]) / n_new
                agg["exact_match"] = (agg["exact_match"] * agg["n"]
                                      + em * pb.shape[0]) / n_new
                agg["n"] = n_new
        row["prefix_vs_oneshot_acc_delta"] = round(
            row["comp_prefix"]["token_accuracy"]
            - row["comp_oneshot"]["token_accuracy"], 4)
        results[f"context{t}"] = row
        print(f"T={t} (chunk {chunk}): "
              + "  ".join(f"{k} acc={v['token_accuracy']:.3f}"
                          for k, v in row.items()
                          if isinstance(v, dict)), flush=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    print(f"wrote {out_path}", flush=True)
    return {"results": results, "params": params, "mcfg": mcfg,
            "ccfg": ccfg, "model_calls": calls}


if __name__ == "__main__":
    main()
