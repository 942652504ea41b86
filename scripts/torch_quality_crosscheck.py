"""Recall of the port's quality-demo model through both packages (CPU).

    python3 scripts/torch_quality_crosscheck.py PARAMS_DIR \
        [--fillers 48,112,240] [--arms baseline_fp,balanced_8_4_2,...]

PARAMS_DIR holds a recall model that the port's quality demo trained and
saved (`python -m realtime_kv_cache_compression_tpu_torch.experiments.
quality_demo --tasks recall --params-dir DIR` writes DIR/recall; pass
DIR/recall), at the demo's default shape (4 layers, width 128, payload 8)
or the one given by --model-layers / --model-width. For each filler and
arm it evaluates the demo's 64 samples of that filler through the port's
`recall_accuracy` and through the JAX package's (the repository's
`experiments/quality_demo.py`) on the same weights and the same samples,
and prints both token accuracies. Where they agree, a difference between
the port's quality-demo table and the JAX package's r4 artifact comes from
the two trainings (other random draws), not from the compressed path.
Runs on the CPU; imports JAX, like the port's tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("params_dir")
    ap.add_argument("--fillers", default="48,112,240")
    ap.add_argument("--arms", default="baseline_fp,conservative,"
                    "balanced_8_4_2,balanced_log_bias,reference_anchor,"
                    "quant_only_8_4_2,query_guided")
    ap.add_argument("--model-layers", type=int, default=4)
    ap.add_argument("--model-width", type=int, default=128)
    ap.add_argument("--payload", type=int, default=8)
    ap.add_argument("--eval-samples", type=int, default=64)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    import realtime_kv_cache_compression_tpu as rj
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        quality_demo as tqd)
    from realtime_kv_cache_compression_tpu_torch.models import (checkpoint,
                                                                llama)

    spec = importlib.util.spec_from_file_location(
        "jax_quality_demo", ROOT / "experiments" / "quality_demo.py")
    jqd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jqd)

    fillers = [int(f) for f in args.fillers.split(",")]
    max_pos = max(fillers) + (args.payload + 1) * (tqd.N_DOCS + 2) + 16
    mcfg = tqd.model_config(args.model_width, args.model_layers, max_pos)
    jcfg = rj.tiny_test_model(**{
        k: getattr(mcfg, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "head_dim",
            "max_position_embeddings")})
    params = checkpoint.load_checkpoint(
        args.params_dir, llama.init_params(0, mcfg, device="cpu"), "cpu")

    def to_jax(t):
        return jnp.asarray(t.numpy())

    j_params = {k: ([{n: to_jax(t) for n, t in layer.items()} for layer in v]
                    if k == "layers" else to_jax(v))
                for k, v in params.items()}
    arms = tqd.arm_configs(mcfg.num_layers, args.payload)
    for filler in fillers:
        batch = tqd.eval_ids(mcfg, "recall", args.eval_samples, args.payload,
                             filler, device="cpu")
        # The JAX demo evaluates the port's samples of this filler.
        jqd.make_batch = lambda *a, batch=batch, **k: tuple(
            jnp.asarray(np.asarray(x)) if torch.is_tensor(x) else x
            for x in batch)
        for name in args.arms.split(","):
            ccfg = arms[name]
            j_ccfg = (None if ccfg is None
                      else rj.CompressionConfig(**dataclasses.asdict(ccfg)))
            port = tqd.recall_accuracy(params, mcfg, ccfg, "recall",
                                       args.eval_samples, args.payload,
                                       filler)
            ref = jqd.recall_accuracy(j_params, jcfg, j_ccfg, "recall",
                                      args.eval_samples, args.payload,
                                      filler)
            print(f"filler {filler} {name}: port {port['token_accuracy']:.4f}"
                  f", JAX package {ref['token_accuracy']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
