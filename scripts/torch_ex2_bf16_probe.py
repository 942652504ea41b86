"""K1's exp_bf16 against the port's model of it: the instruction, then the
kernel.

    python3 scripts/torch_ex2_bf16_probe.py

K1's exp_bf16 variant exponentiates with PTX `ex2.approx.ftz.bf16x2`, which
PTX specifies only as approximate. The plain version that holds the variant
(`ops/attention.prefill_attention_with_prompt_mass(exp_bf16=True)`) models
the instruction by `ops/attention.ex2_bf16`. This script

1. compiles a one-instruction kernel (nvcc, sm_90a, into the git-ignored
   build/), runs it on all 65536 bf16 bit patterns, and compares the
   results bit for bit with `ex2_bf16` run on the CPU and on the card,
   beside the count where round-to-nearest bf16 of exp2 differs;
2. holds every exp_bf16 combination of `flash_prefill_with_prompt_mass`
   at the card tests' variant shapes (B=2, S=333, prompt 150, per-row
   prompt lengths 100 and 333, 8/2 and 14/2 heads, every head_dim, bf16
   and float32, seeded) to the plain version with the same flag and
   running maximum, and the default kernel on the same inputs to the same
   plain version: each call's output as a share of `bf16_output_limit`
   and its prompt mass's largest error, and the worst of each.

It prints the card's `nvidia-smi` name and power limit first, and exits 1
on any difference in part 1. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from realtime_kv_cache_compression_tpu_torch.ops.attention import (  # noqa: E402
    ex2_bf16, prefill_attention_with_prompt_mass)
from realtime_kv_cache_compression_tpu_torch.ops.cuda import (  # noqa: E402
    _build, flash_prefill as fp)

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void ex2_kernel(const uint32_t* in, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t y;
    asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(in[i]));
    out[i] = y;
  }
}
extern "C" int ex2_bf16x2(const void* in, void* out, int n) {
  ex2_kernel<<<(n + 255) / 256, 256>>>(static_cast<const uint32_t*>(in),
                                       static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def card_ex2(x: torch.Tensor) -> torch.Tensor:
    """The instruction on bf16 x (an even count), as bf16 on the CPU."""
    out_dir = ROOT / "build" / "ex2_bf16_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "probe.cu").write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(out_dir / "probe.so"), str(out_dir / "probe.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out_dir / "probe.so"))
    lanes = x.contiguous().view(torch.int32).cuda()   # two bf16 a word
    out = torch.empty_like(lanes)
    rc = lib.ex2_bf16x2(ctypes.c_void_p(lanes.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()), lanes.numel())
    if rc:
        raise RuntimeError(f"ex2 probe kernel failed: CUDA error {rc}")
    return out.cpu().view(torch.bfloat16)


def kernel_against_model() -> None:
    """Part 2: exp_bf16's calls and the default's against the plain
    version with exp_bf16, at the card tests' variant shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for d in fp._HEAD_DIMS:
        for hq, hkv in ((8, 2), (14, 2)):
            q = torch.randn((2, 333, hq, d), generator=gen, device=dev)
            k, v = (torch.randn((2, 333, hkv, d), generator=gen, device=dev)
                    for _ in range(2))
            plens = torch.tensor([100, 333], device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                qd, kd, vd = (x.to(dtype) for x in (q, k, v))
                blk = fp.exp_block_keys(dtype, fp.default_tile(fp._CAUSAL, d))
                f = [x.float() for x in (qd, kd, vd)]
                o_ref, pm_ref = prefill_attention_with_prompt_mass(
                    *f, 150, prompt_lens=plens, exp_bf16=True,
                    exp_block_k=blk)
                o_abs = prefill_attention_with_prompt_mass(
                    f[0], f[1], f[2].abs(), 150, prompt_lens=plens,
                    exp_bf16=True, exp_block_k=blk)[0]
                for var in (0, 2, 3, 6, 7):   # 0: the default kernel
                    if hq == 14 and var and not var & 1:
                        continue
                    flags = {n: bool(var & b) for n, b in fp.VARIANT_FLAGS}
                    o, pm = fp.flash_prefill_with_prompt_mass(
                        qd, kd, vd, 150, prompt_lens=plens, **flags)
                    share = fp.bf16_limit_share(o, o_ref, o_abs)
                    pm_err = float((pm - pm_ref).abs().max())
                    name = fp.variant_name(var) or "the default kernel"
                    print(f"d={d} {hq}/{hkv} {str(dtype)[6:]} {name}: output "
                          f"at {share:.3f} of bf16_output_limit, prompt "
                          f"mass {pm_err:.3e}")
                    key = ("default" if not var else "exp_bf16",
                           str(dtype)[6:])
                    lo = worst.setdefault(key, [9.0, 0.0, 1.0, 0.0])
                    lo[:] = [min(lo[0], share), max(lo[1], share),
                             min(lo[2], pm_err), max(lo[3], pm_err)]
    for (kind, dtype), (s0, s1, p0, p1) in sorted(worst.items()):
        print(f"{kind} {dtype}: output at {s0:.3f}-{s1:.3f} of the limit, "
              f"prompt mass {p0:.2e}-{p1:.2e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16)
    finite = torch.isfinite(x.float())
    got = card_ex2(x).float()
    worst = 0
    for where, model in (("cpu", ex2_bf16(x)),
                         ("cuda", ex2_bf16(x.cuda()).cpu())):
        bad = finite & (got.view(torch.int32) != model.view(torch.int32))
        worst = max(worst, int(bad.sum()))
        print(f"ex2_bf16 on the {where} against the card's "
              f"ex2.approx.ftz.bf16x2: {int(bad.sum())} of "
              f"{int(finite.sum())} finite bf16 inputs differ"
              + (f", e.g. x={x[bad][:4].float().tolist()}" if bad.any()
                 else ""))
    rn = torch.exp2(x.float()).to(torch.bfloat16).float()
    print(f"round-to-nearest bf16 of exp2 differs from the card on "
          f"{int((finite & (got != rn)).sum())} of them")
    if worst:
        return 1
    kernel_against_model()
    return 0


if __name__ == "__main__":
    sys.exit(main())
