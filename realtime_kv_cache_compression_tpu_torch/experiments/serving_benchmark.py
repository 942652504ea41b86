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
warm-up's). `--mesh` (sharded serving) raises NotImplementedError: it
waits for `ServingEngine(mesh=)`, which comes after `pipeline.py` and
`multihost.py`, in the rest of ROADMAP item 18.
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
from ..serving.engine import ServingEngine


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
                    help="DATAxMODEL mesh (not ported: raises)")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Runs the benchmark; returns {"summary": the engine's, "wall_s",
    "warmup_s", "completed": {rid: request}, "model_calls": the engine's
    schedule over the warm-up and the timed run, "engine"} for in-process
    callers."""
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: sharded serving waits for ServingEngine(mesh=), which "
            "comes after pipeline.py and multihost.py, in the rest of "
            "ROADMAP item 18")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

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
                        decode_chunk=args.decode_chunk)
    warmup_s = 0.0
    if not args.no_warmup:
        warmup_s = eng.warmup()["wall_s"]
        print(f"warmup: {warmup_s:.1f}s")
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        n = int(rng.integers(args.context // 2, args.context))
        eng.submit(rng.integers(1, mcfg.vocab_size, size=n).tolist())
    done = eng.run()
    wall = time.time() - t0
    s = eng.summary()
    print(f"requests={len(done)} wall={wall:.2f}s "
          f"throughput={s['total_tokens'] / wall:.1f} tok/s "
          f"avg_ttft={s['avg_ttft_s'] * 1e3:.1f}ms "
          f"avg_savings={s['avg_memory_savings']:.3f}")
    return {"summary": s, "wall_s": wall, "warmup_s": warmup_s,
            "completed": dict(done), "model_calls": dict(eng.model_calls),
            "engine": eng}


if __name__ == "__main__":
    main()
