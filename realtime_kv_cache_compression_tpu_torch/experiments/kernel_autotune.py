"""Sweep K1's tile (block_q x block_k) over the flash prefill, on the port.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.kernel_autotune \
        [--seq 4096 --heads 32 --kv-heads 4 --head-dim 64 --batch 1] \
        [--blocks 64 128] [--device cuda]

The counterpart of the repository's `experiments/kernel_autotune.py`
(which sweeps the Pallas kernel on a TPU): the same switches, defaults
and inputs (q, k, v in bf16 from numpy `default_rng(0)`, prompt length
128), every (block_q, block_k) of `--blocks` x `--blocks` through
`flash_prefill_with_prompt_mass`, and the same artifact
(`flash_autotune.json`: `results`, `best`, `shape`) and last line
(`BEST: ...`). `--blocks` defaults to the card's tiles, 64 and 128 (JAX's
128-1024 are TPU sizes). A pair the build lacks is recorded with the
wrapper's refusal as `error`, as JAX records a failed config; any other
failure, and an output off its plain version, ends the run with a nonzero
exit.

On the card each pair is held once against the plain version on float32
copies of the inputs (the output within `bf16_output_limit`, the prompt
mass within 1e-5), then timed by CUDA events (`utils/timing.cuda_ms` over
REPS calls) after a warm-up call: the median of RUNS readings with their
spread, JAX's TFLOP/s formula (4 B S^2 / 2 Hq D operations, the causal
half), and the share of the operations bound at 989 TFLOP/s (bf16, H100
SXM). The artifact carries the card's `nvidia-smi` name and power limit.
On the CPU (`--device cpu`, small shapes) each pair runs the wrapper's
plain version once: its host time means nothing, and the artifact says
so.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time
from typing import Any, Dict

import numpy as np
import torch

from ..ops.attention import prefill_attention_with_prompt_mass
from ..ops.cuda import flash_prefill as fp
from ..utils.timing import cuda_ms, median, spread

PROMPT_LEN = 128
TOL_MASS = 1e-5
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA's data sheet)
RUNS = 5    # timed readings per pair
REPS = 10   # calls per reading


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--blocks", nargs="+", type=int, default=[64, 128])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--output-dir",
                    default="experiments/results_torch/autotune")
    return ap.parse_args(argv)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    the run had instead."""
    if device.type != "cuda":
        return f"{device.type}: no card (times are host times of the plain " \
               f"version and mean nothing)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[torch.cuda.current_device()]


def main(argv=None) -> Dict[str, Any]:
    """Runs the sweep, writes the artifact and returns its dict."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    b, s, hq, hkv, d = (args.batch, args.seq, args.heads, args.kv_heads,
                        args.head_dim)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to(
        device=device, dtype=torch.bfloat16)
        for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    flops = 4 * b * s * s / 2 * hq * d  # causal: about half the square
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    on_card = device.type == "cuda"
    if on_card:
        f32 = [t.float() for t in (q, k, v)]
        o_ref, pm_ref = prefill_attention_with_prompt_mass(*f32, PROMPT_LEN)
        o_abs = prefill_attention_with_prompt_mass(
            f32[0], f32[1], f32[2].abs(), PROMPT_LEN)[0]
        del f32

    results, failed = [], []
    for bq, bk in itertools.product(args.blocks, args.blocks):
        if bq > s or bk > s:
            continue
        try:
            fp.resolve_tile(fp._CAUSAL, d, s, s, bq, bk)
        except ValueError as e:  # a tile the build lacks
            results.append({"block_q": bq, "block_k": bk, "error": repr(e)})
            print(f"bq={bq} bk={bk}: {type(e).__name__}: {e}", flush=True)
            continue

        def call():
            return fp.flash_prefill_with_prompt_mass(  # noqa: B023
                q, k, v, PROMPT_LEN, block_q=bq, block_k=bk)

        if not on_card:
            t0 = time.perf_counter()
            call()
            ms = (time.perf_counter() - t0) * 1e3
            results.append({"block_q": bq, "block_k": bk, "ms": ms})
            print(f"bq={bq} bk={bk}: plain version on {device.type} "
                  f"{ms:.2f} ms (no kernel)", flush=True)
            continue
        o, pm = call()
        share_err = fp.bf16_limit_share(o, o_ref, o_abs)
        err = float((o.float() - o_ref).abs().max())
        pm_err = float((pm - pm_ref).abs().max())
        readings = [cuda_ms(call, REPS)[1] for _ in range(RUNS)]
        ms = median(readings)
        row = {"block_q": bq, "block_k": bk, "ms": ms,
               "spread": spread(readings), "tflops": flops / ms / 1e9,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
               "max_abs_err": err, "worst_share_of_bf16_limit": share_err,
               "prompt_mass_max_abs_err": pm_err}
        results.append(row)
        print(f"bq={bq} bk={bk}: {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
              f"{row['share_of_bound']:.3f} of the bound; {row['spread']}); "
              f"error {err:.3e} at {share_err:.3f} of the bf16 limit, prompt "
              f"mass {pm_err:.2e}", flush=True)
        if share_err > 1.0 or pm_err > TOL_MASS:
            failed.append((bq, bk))

    os.makedirs(args.output_dir, exist_ok=True)
    ok = [r for r in results if "error" not in r]
    best = min(ok, key=lambda r: r["ms"]) if ok else None
    artifact = {"results": results, "best": best,
                "shape": dict(b=b, s=s, hq=hq, hkv=hkv, d=d),
                "device": device_line(device),
                "timing": (f"CUDA events, median of {RUNS} readings of "
                           f"{REPS} calls after a warm-up" if on_card else
                           "host clock of the plain version, one call: no "
                           "device time, the times mean nothing")}
    with open(os.path.join(args.output_dir, "flash_autotune.json"),
              "w") as f:
        json.dump(artifact, f, indent=2)
    if failed:
        raise SystemExit(f"kernel_autotune: tiles {failed} are off their "
                         f"plain version")
    if best:
        print(f"BEST: block_q={best['block_q']} block_k={best['block_k']} "
              f"{best['ms']:.2f} ms")
    return artifact


if __name__ == "__main__":
    main()
