"""K2's default call across trees, bit for bit.

    python3 scripts/torch_k2_bits_ab.py TREE_A TREE_B [TREE ...]

Each TREE is the root of a checkout that holds
`realtime_kv_cache_compression_tpu_torch/` (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and `.`). Each
tree runs in a fresh process that imports the package from that tree and
builds its kernels there, then calls `fused_decode_attention` (no lse) on
seeded states: tiers + ring at TinyLlama's heads (32/4, d=64) and at
Llama-2-7B's (32/32, d=128), and tiers + a 4-bit decode pool at G=2 + ring
at TinyLlama's, each in bf16 and float32. It prints a SHA-256 of every
output's bytes per tree and whether every tree gave the same bits. Needs
one CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
# (name, b, s, hq, hkv, d, pooled)
STATES = (("tinyllama", 2, 4096, 32, 4, 64, False),
          ("llama2_7b", 1, 4096, 32, 32, 128, False),
          ("tinyllama_pool_g2", 2, 2048, 32, 4, 64, True))


def measure(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import realtime_kv_cache_compression_tpu_torch as rt
    from realtime_kv_cache_compression_tpu_torch.compression.compressor \
        import compress_layer_kv
    from realtime_kv_cache_compression_tpu_torch.compression.kv_cache import (
        append_recent, flush_recent, init_decode_pool, init_recent_cache)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import fused_decode_attention

    dev = torch.device("cuda")
    out = {"tree": tree}
    for name, b, s, hq, hkv, d, pooled in STATES:
        for dtype in (torch.bfloat16, torch.float32):
            mcfg = rt.tiny_test_model(num_heads=hq, num_kv_heads=hkv,
                                      head_dim=d,
                                      dtype=str(dtype).split(".")[1])
            ccfg = rt.CompressionConfig(
                num_layers=4, quant_group_size=d // 2 if pooled else 0,
                decode_pool_blocks=4 if pooled else 0)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            rnd = lambda *shape: torch.randn(  # noqa: E731
                shape, generator=gen, device=dev).to(dtype)
            cache, _ = compress_layer_kv(
                rnd(b, s, hkv, d), rnd(b, s, hkv, d),
                torch.rand((b, s), generator=gen, device=dev), 0, ccfg, mcfg)
            ring = 16
            recent = init_recent_cache(b, ring, mcfg, device=dev)
            pool = (init_decode_pool(b, ring, ccfg, mcfg, device=dev)
                    if pooled else None)
            steps = 3 * ring + 5 if pooled else 5
            for i in range(steps):
                if pooled and i and i % ring == 0:
                    flush_recent(recent, pool, ccfg, mcfg)
                pos = torch.full((b, 1), s + i, dtype=torch.int32, device=dev)
                append_recent(recent, rnd(b, 1, hkv, d), rnd(b, 1, hkv, d),
                              pos)
            q = rnd(b, 1, hq, d)
            q_pos = torch.full((b, 1), s + steps, dtype=torch.int32,
                               device=dev)
            o = fused_decode_attention(q, cache, recent, q_pos, ccfg,
                                       pool=pool)
            bits = o.view(torch.int16 if dtype == torch.bfloat16
                          else torch.int32).cpu().numpy().tobytes()
            out[f"{name}_{str(dtype).split('.')[1]}"] = hashlib.sha256(
                bits).hexdigest()
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--measure":
        print("AB " + json.dumps(measure(argv[1])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for tree in argv:
        res = subprocess.run([sys.executable, __file__, "--measure", tree],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(res.stderr[-4000:])
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode or not line:
            print(f"{tree}: failed (rc {res.returncode})", flush=True)
            return 1
        rows.append(json.loads(line[-1][3:]))
        print(line[-1][3:], flush=True)
    keys = [k for k in rows[0] if k != "tree"]
    same = all(r[k] == rows[0][k] for r in rows for k in keys)
    print(f"K2 default call, {len(keys)} outputs over {len(rows)} trees: "
          f"{'the same bits' if same else 'bits differ'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
