"""Speculative-decoding benchmark on the compressed KV cache, on the port.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.speculative_benchmark \
        --fillers 512,4096 --payload 48 --n-draft 4 --adaptive

Trains the recall model with the port's trainer (quality_demo's task: the
continuation copies a payload span from the prompt, as long-context QA and
summarization outputs do), then times greedy decode against speculative
decode with prompt-lookup drafting through the compressed cache, and with
`--adaptive` against the adaptive controller. The counterpart of the
repository's `experiments/speculative_benchmark.py` (which drives the JAX
package): the same model (float32, vocab 256, so filler bigrams rarely
shadow the payload's), arms, assertions and artifact
(`speculative_benchmark.json`); the samples come from `torch.Generator`s
seeded 7 + filler, so other draws than `jax.random`'s.

The arms' tokens are asserted equal to greedy's before any time is
reported; where they part, the error names the first step apart and the
greedy decode's two top logits there. On the port: `--device` (cuda by
default) replaces `--platform`, and `--flash` goes: on a CUDA device the
prefill runs K1 and greedy decode (and the adaptive arm's plain chunks)
K2; the speculative verify forward is plain attention in both packages.
Times are CUDA events on the card (a host clock on the CPU) after a
warm-up run of each arm: the median of `--reps` runs, with their spread.
Each run decodes from its own copy of the prefill state (decode updates
rings and pools in place). `--params-dir` loads the trained weights from
DIR/<task> (the port's `models/checkpoint.py`), else trains and saves
there.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Any, Dict

import torch

from .. import CompressionConfig, tiny_test_model
from ..models import checkpoint, llama, speculative
from ..utils.timing import cuda_ms, median, spread
from .quality_demo import make_batch, train_recall_model


def model_config(layers: int, max_pos: int):
    """The recall model: hidden 128, 4 / 2 heads of 32, vocab 256,
    float32."""
    return tiny_test_model(vocab_size=256, hidden_size=128,
                           intermediate_size=256, num_layers=layers,
                           num_heads=4, num_kv_heads=2, head_dim=32,
                           max_position_embeddings=max_pos)


def _run_ms(fn, device: torch.device) -> float:
    """Milliseconds of one fn() call: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn)[1]
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _first_apart(params, first, state, ref, toks, mcfg, ccfg) -> str:
    """Where `toks` leaves greedy's `ref` ([B, n]): the row, the step and
    greedy's two top logits there, replayed by `decode_step` from a copy
    of the prefill state."""
    r, t = (int(x) for x in (toks != ref).nonzero()[0])
    state = llama.clone_decode_state(state)
    tok = first
    for _ in range(t + 1):
        logits, state = llama.decode_step(params, tok, state, mcfg, ccfg)
        tok = torch.argmax(logits, dim=-1)
    top = torch.topk(logits[r].float(), 2)
    return (f"row {r} step {t}: greedy {int(ref[r, t])}, arm "
            f"{int(toks[r, t])}; greedy's top-2 logits "
            f"{top.values.tolist()} at ids {top.indices.tolist()}")


def bench_prompt(params, prompt, payload, mcfg, ccfg, n_draft: int = 4,
                 reps: int = 3, adaptive: bool = False, chunk: int = 16
                 ) -> Dict[str, Any]:
    """One filler's row: the compressed prefill of prompt [B, S], then
    `payload.shape[1]` steps of greedy `decode_loop`, of
    `speculative_decode_loop` and (with `adaptive`)
    `adaptive_speculative_decode`, each arm's tokens asserted equal to
    greedy's, then each timed `reps` times. Returns the row plus "tokens"
    (greedy's [B, n], on the host) and "model_calls" (this row's prefills
    and decode steps: K1 and K2 run once per layer in each on the card)."""
    device = prompt.device
    b, n_steps = payload.shape
    logits, state, _ = llama.prefill_compressed(
        params, prompt, mcfg, ccfg, max_decode_len=n_steps + n_draft + 1)
    first = torch.argmax(logits, dim=-1)

    # Each arm decodes from a copy of the prefill state (made before a
    # timed run starts).
    def greedy(st):
        return llama.decode_loop(params, first, st, n_steps, mcfg, ccfg)[0]

    def spec(st):
        toks, _, stats = speculative.speculative_decode_loop(
            params, first, st, n_steps, mcfg, ccfg, prompt_ids=prompt,
            n_draft=n_draft)
        return toks, stats

    def adapt(st):
        toks, _, stats = speculative.adaptive_speculative_decode(
            params, first, st, n_steps, mcfg, ccfg, prompt_ids=prompt,
            n_draft=n_draft, chunk=chunk)
        return toks, stats

    def timed(arm):
        return [_run_ms(functools.partial(arm, llama.clone_decode_state(
            state)), device) for _ in range(reps)]

    def check(toks, arm):
        if not torch.equal(ref, toks):
            raise AssertionError(f"{arm} != greedy output: " + _first_apart(
                params, first, state, ref, toks, mcfg, ccfg))

    ref = greedy(llama.clone_decode_state(state))  # also the warm-up
    toks, st = spec(llama.clone_decode_state(state))
    check(toks, "speculative")
    gen = torch.cat([first[:, None], ref[:, :-1]], dim=1)
    em = float((gen == payload).all(dim=1).float().mean())
    greedy_runs, spec_runs = timed(greedy), timed(spec)
    greedy_ms, spec_ms = median(greedy_runs), median(spec_runs)
    decode_steps = n_steps * (1 + reps)
    row = dict(
        n_steps=n_steps, eval_batch=b, n_draft=n_draft, em=em,
        iterations=st["iterations"],
        accept_rate=st["drafted_accepted"] / max(
            st["iterations"] * n_draft * b, 1),
        greedy_ms=greedy_ms, spec_ms=spec_ms,
        greedy_ms_spread=spread(greedy_runs), spec_ms_spread=spread(spec_runs),
        greedy_tok_s=n_steps * b / greedy_ms * 1e3,
        spec_tok_s=n_steps * b / spec_ms * 1e3,
        speedup=greedy_ms / spec_ms,
    )
    if adaptive:
        toks, st_a = adapt(llama.clone_decode_state(state))  # warm-up too
        check(toks, "adaptive")
        runs = timed(adapt)
        # The plain chunks' tokens, each chunk `chunk` long but the last.
        plain = sum(min(chunk, n_steps - i * chunk)
                    for i, (arm, _) in enumerate(st_a["arms"])
                    if arm == "plain")
        decode_steps += plain * (1 + reps)
        row["adaptive"] = dict(
            ms=median(runs), ms_spread=spread(runs),
            speedup=greedy_ms / median(runs), forwards=st_a["forwards"],
            spec_chunks=st_a["spec_chunks"],
            plain_chunks=st_a["plain_chunks"], plain_tokens=plain,
            draft_rate=st_a["draft_rate"], chunk=chunk)
    row["tokens"] = ref.cpu()
    row["model_calls"] = {"prefill": 1, "decode_steps": decode_steps}
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--task", default="recall", choices=["recall", "multidoc"])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--payload", type=int, default=48)
    ap.add_argument("--fillers", default="512,4096")
    ap.add_argument("--n-draft", type=int, default=4)
    ap.add_argument("--eval-batch", type=int, default=1)
    ap.add_argument("--model-layers", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--adaptive", action="store_true",
                    help="add an adaptive_speculative_decode arm (host-side "
                    "controller that falls back to plain decode chunks when "
                    "realized tokens-per-forward collapses)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="adaptive arm chunk length")
    ap.add_argument("--params-dir", default=None,
                    help="load the trained model from PARAMS_DIR/<task> if "
                    "present, else train and save there")
    ap.add_argument("--output-dir",
                    default="experiments/results_torch/speculative")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Runs the benchmark; returns {"results": the artifact's rows,
    "tokens": {filler: greedy tokens}, "params", "mcfg", "ccfg",
    "model_calls": the run's prefills and decode steps} for in-process
    callers."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    fillers = [int(f) for f in args.fillers.split(",")]
    mcfg = model_config(args.model_layers,
                        max(fillers) + (args.payload + 1) * 8 + 16)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=8,
                             medium_precision_bits=4,
                             low_precision_bits=2)
    ckpt = (os.path.join(os.path.abspath(args.params_dir), args.task)
            if args.params_dir else None)
    if ckpt and os.path.exists(ckpt):
        params = checkpoint.load_checkpoint(
            ckpt, llama.init_params(0, mcfg, device=device), device)
        print(f"loaded {args.task} params from {ckpt}", flush=True)
    else:
        print(f"training {args.task} model (fillers {fillers})...",
              flush=True)
        params = train_recall_model(mcfg, args.task, args.steps,
                                    args.train_batch, args.payload, fillers,
                                    lr=args.lr, device=device)
        if ckpt:
            checkpoint.save_checkpoint(ckpt, params)
            print(f"saved {args.task} params to {ckpt}", flush=True)

    results, tokens = [], {}
    calls = {"prefill": 0, "decode_steps": 0}
    for filler in fillers:
        gen = torch.Generator(device=device).manual_seed(7 + filler)
        ids, prompt_len, payload = make_batch(
            gen, args.eval_batch, args.payload, filler, mcfg.vocab_size,
            args.task)
        row = bench_prompt(params, ids[:, :prompt_len], payload, mcfg, ccfg,
                           n_draft=args.n_draft, reps=args.reps,
                           adaptive=args.adaptive, chunk=args.chunk)
        tokens[filler] = row.pop("tokens")
        for k, v in row.pop("model_calls").items():
            calls[k] += v
        row = {"filler": filler, **row}
        results.append(row)
        print(f"[filler={filler}] em={row['em']:.3f} "
              f"iters={row['iterations']}/{row['n_steps']} "
              f"accept={row['accept_rate']:.2f} greedy "
              f"{row['greedy_ms']:.1f} ms vs spec {row['spec_ms']:.1f} ms "
              f"-> {row['speedup']:.2f}x", flush=True)
        if "adaptive" in row:
            a = row["adaptive"]
            print(f"[filler={filler}] adaptive {a['ms']:.1f} ms -> "
                  f"{a['speedup']:.2f}x (spec_chunks={a['spec_chunks']} "
                  f"plain_chunks={a['plain_chunks']} "
                  f"forwards={a['forwards']})", flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    out = dict(task=args.task, model_layers=args.model_layers,
               payload=args.payload, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               argv=list(sys.argv[1:] if argv is None else argv),
               results=results,
               timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
    path = os.path.join(args.output_dir, "speculative_benchmark.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}", flush=True)
    return {"results": results, "tokens": tokens, "params": params,
            "mcfg": mcfg, "ccfg": ccfg, "model_calls": calls}


if __name__ == "__main__":
    main()
