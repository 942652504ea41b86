"""K1's default calls across trees, bit for bit.

    python3 scripts/torch_k1_bits_ab.py TREE_A TREE_B [TREE ...]

Each TREE is the root of a checkout that holds
`realtime_kv_cache_compression_tpu_torch/` (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and `.`). Each
tree runs in a fresh process that imports the package from that tree and
builds its kernels there (its build seconds are printed: 0.0 where an
earlier build of the same sources was reused), then calls every K1
wrapper with no tile or variant argument on seeded inputs at TinyLlama's
heads (32/4, d=64) and Llama-2-7B's (32/32, d=128), in bf16 and float32:
mode (a) with ragged prompt lengths, mode (b) (a chunk of 1024 at offset
1024 over 4096 keys), the diagonal pair, mode (c) and mode (d) (1024
queries over 2048 unordered slots, a fifth invalid). It prints a SHA-256
of the bytes of every output (o, the lse where returned, the prompt mass)
per tree and each default bf16 instance's registers, and whether every
tree gave the same bits and registers. Needs one CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
HEADS = (("tinyllama", 32, 4, 64), ("llama2_7b", 32, 32, 128))


def measure(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from realtime_kv_cache_compression_tpu_torch.ops.cuda import _build
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
        flash_prefill as fp)

    # `kernel_instances()` lists each mode's default instances first (a
    # tree without tiles or variants lists nothing else).
    regs = {}
    for r in fp.kernel_instances():
        if r["dtype"] == "bfloat16":
            regs.setdefault(f"{r['mode']} d={r['head_dim']}", r["regs"])
    out = {"tree": tree,
           "build_seconds": round(_build.load_library().build_seconds, 1),
           "regs": regs}
    dev = torch.device("cuda")
    for name, hq, hkv, d in HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)

            b, s, c = 2, 4096, 1024
            q, k, v = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
            plens = torch.tensor([100, 3000], device=dev)
            pos = torch.randperm(s, device=dev, generator=gen)[:2 * c]
            kpos = torch.where(
                torch.rand((b, 2 * c), generator=gen, device=dev) > 0.2,
                pos.to(torch.int32)[None].expand(b, -1),
                fp.POS_SENTINEL).to(torch.int32).contiguous()
            calls = {
                "a": lambda: fp.flash_prefill_with_prompt_mass(
                    q, k, v, 3000, prompt_lens=plens),
                "b": lambda: fp.flash_chunk_attention_with_prompt_mass(
                    q[:, c:2 * c], k, v, c, 3000, prompt_lens=plens),
                "pair": lambda: fp.flash_diagonal_pair_attention(
                    q[:, :c], k[:, :c], v[:, :c], plens.clamp(max=c)),
                "c": lambda: fp.flash_full_pair_attention(
                    q[:, c:2 * c], k[:, :c], v[:, :c], plens.clamp(max=c)),
                "d": lambda: fp.flash_positioned_attention(
                    q[:, 2 * c:3 * c], k[:, :2 * c], v[:, :2 * c], kpos,
                    2 * c, 3000),
            }
            for mode, call in calls.items():
                h = hashlib.sha256()
                for t in call():
                    h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                             .tobytes())
                out[f"{name}_{mode}_{str(dtype)[6:]}"] = h.hexdigest()
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
    keys = [k for k in rows[0] if k not in ("tree", "build_seconds", "regs")]
    same = all(r[k] == rows[0][k] for r in rows for k in keys)
    regs = all(r["regs"] == rows[0]["regs"] for r in rows)
    print(f"K1 default calls, {len(keys)} outputs over {len(rows)} trees: "
          f"{'the same bits' if same else 'bits differ'}; the "
          f"{len(rows[0]['regs'])} default bf16 instances' registers "
          f"{'the same' if regs else 'differ'}")
    return 0 if same and regs else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
