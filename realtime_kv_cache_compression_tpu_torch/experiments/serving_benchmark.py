"""Continuous-batching serving benchmark on the port: sustained throughput
and TTFT under concurrent requests.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.serving_benchmark \
        --model tinyllama

The counterpart of the repository's `experiments/serving_benchmark.py`
(which drives the JAX package): the port's `ServingEngine` with random
weights from seed 0, a warm-up that admits one batch at every power-of-two
admission size up to the slot count (`ServingEngine.warmup`: every
admission pads its prompts to the context bucket, so these are all the
prefill shapes the timed run can take), then `--requests` prompts of
context/2 to context tokens submitted at once and served to the end,
timed on the host clock, and one summary line: requests, wall, generated
tokens per second, mean TTFT and mean byte savings.

On the port: `--device` (cuda by default) replaces `--platform`, and
`--flash` goes: on a CUDA device every admission's prefill runs K1 and
every decode chunk K2, on the CPU their plain versions. The warm-up
leaves no request or aggregate behind, so the summary counts the timed
requests only (the JAX script's engine summary also counts the
warm-up's). `--mesh DATAxMODEL` serves over a mesh of D·M ranks
(`parallel.run_ranks`, one process each over gloo, on one device):
every rank builds the same weights and runs `ServingEngine(mesh=)` on the
same submissions, the weights split over `model` and the slots over
`data`; rank 0 prints and reports.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import TINYLLAMA_1_1B, CompressionConfig, tiny_test_model
from ..models import llama
from ..parallel import create_mesh, run_ranks
from ..serving.engine import ServingEngine

# The ranks of a mesh run the whole benchmark; this bounds it (and each
# collective).
RANK_TIMEOUT = 3600.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--model", default="tinyllama",
                    choices=["tiny-test", "tinyllama"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up admissions (the timed run then "
                         "includes the kernels' first-use builds)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh, e.g. 2x2: D*M ranks, slots "
                         "sharded over data, weights tensor-parallel")
    return ap.parse_args(argv)


def _mesh_shape(spec: str):
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DATAxMODEL, e.g. 2x2")
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec!r}: sizes must be positive")
    return data, model


def run(args, mesh=None, verbose: bool = True) -> Dict[str, Any]:
    """The benchmark on this process: the whole engine, or this rank's
    part of a sharded one over `mesh`. Returns `main`'s dict."""
    device = torch.device(args.device)
    mcfg = (tiny_test_model() if args.model == "tiny-test"
            else TINYLLAMA_1_1B)
    if args.layers:
        mcfg = dataclasses.replace(mcfg, num_layers=args.layers)
    if mcfg.max_position_embeddings < args.context + args.new_tokens:
        mcfg = dataclasses.replace(
            mcfg, max_position_embeddings=args.context + args.new_tokens)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers,
                             high_precision_bits=8,
                             medium_precision_bits=4,
                             low_precision_bits=2)
    params = llama.init_params(0, mcfg, device=device)
    eng = ServingEngine(params, mcfg, ccfg, num_slots=args.slots,
                        context_len=args.context,
                        max_new_tokens=args.new_tokens,
                        decode_chunk=args.decode_chunk, mesh=mesh)
    del params
    say = print if verbose else (lambda *a, **k: None)
    warmup_s = 0.0
    if not args.no_warmup:
        warmup_s = eng.warmup()["wall_s"]
        say(f"warmup: {warmup_s:.1f}s")
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        n = int(rng.integers(args.context // 2, args.context))
        eng.submit(rng.integers(1, mcfg.vocab_size, size=n).tolist())
    done = eng.run()
    wall = time.time() - t0
    s = eng.summary()
    if mesh is not None:
        say(f"mesh: data={mesh.shape['data']} model={mesh.shape['model']}")
    say(f"requests={len(done)} wall={wall:.2f}s "
        f"throughput={s['total_tokens'] / wall:.1f} tok/s "
        f"avg_ttft={s['avg_ttft_s'] * 1e3:.1f}ms "
        f"avg_savings={s['avg_memory_savings']:.3f}")
    return {"summary": s, "wall_s": wall, "warmup_s": warmup_s,
            "completed": dict(done), "model_calls": dict(eng.model_calls),
            "engine": eng}


def _rank_run(rank: int, n: int, group, args) -> Dict[str, Any]:
    """One rank of a mesh run; rank 0 prints. The engine (which holds
    the rank's process groups) stays on the rank."""
    out = run(args, create_mesh(*_mesh_shape(args.mesh)), verbose=rank == 0)
    out["engine"] = None
    return out


def main(argv=None) -> Dict[str, Any]:
    """Runs the benchmark; returns {"summary": the engine's, "wall_s",
    "warmup_s", "completed": {rid: request}, "model_calls": the engine's
    schedule over the warm-up and the timed run, "engine"} for in-process
    callers. Over a mesh of more than one rank they are rank 0's, and
    "engine" is None."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if not args.mesh:
        return run(args)
    data, model = _mesh_shape(args.mesh)
    if data * model == 1:
        return run(args, create_mesh(1, 1))
    return run_ranks(_rank_run, data * model, args=(args,),
                     timeout=RANK_TIMEOUT)[0]


if __name__ == "__main__":
    main()
