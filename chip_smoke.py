"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K4) from
`realtime_kv_cache_compression_tpu_torch/csrc`, one nvcc per source, all at
once, and logs each K1 instance's registers, shared memory and spills
(none allowed in the tensor-core instances: K1's bf16 ones at head_dim
16-256, K3's prefill tile and K4's, each of which must hold wgmma
instructions, HGMMA or IGMMA for int8, where cuobjdump runs) and the stack
frame of every K2 instance. Checks each kernel (K1 in its one-shot mode
(a), chunked mode (b), positioned mode (d), the diagonal pair and the
non-causal pair (c), K2 over tiers + ring and with the decode pool and
scale groups, at the heads of TinyLlama, Llama-2-7B, Gemma-2B and
Gemma-7B, with its device time per call (one launch: the splits merge
inside it); K3 and K4 at the 7B matmul shapes, each on the route its shape
takes) against its plain PyTorch version, in bf16 and float32, with its
time, bound and library yardstick (K1: its share of the bound and its
factor against SDPA; K3 and K4 at M=1 also the GEMV's device time per
launch; K4's yardstick torch._int_mm on the weights as kept and on a
K-major copy), and K1 mode (a) on the model's own activations (TinyLlama,
2 layers, full width, prompt 1024, bf16). Then it drives these paths,
each with every launch count set to 0 just before it and read just after:

- TinyLlama-1.1B shape (22 layers, bf16, fused raw weights): compressed
  prefill with K1 and fused decode with K2, prompt 4096, batch 1, 128 new
  tokens, tiers 8/4/2, counted once and timed REPEATS times, plus the
  uncompressed arm and a torch.profiler breakdown; then the sampled decode
  on the same prefill (temperature 0.8, top-k 50, top-p 0.9, repetition
  penalty 1.1; 127 steps through K2), with its counts and logprobs checked,
  top-k 1 held to the greedy tokens, and its tok/s beside greedy;
- Llama-2-7B (32 layers, hidden 4096, 32/32 heads, d=128), bf16 random
  weights quantized with `quantize_params_streaming(bits=4)` and fused:
  every layer matmul through K3, embed and lm_head int8 weight-only; the
  same prompt, tiers and generation, counted once and timed REPEATS_7B
  times, the uncompressed arm, and a profile;
- the same model under `quantize_params(bits=8, act_quant=True)`: every
  layer matmul and lm_head through K4, counted by route (the prefill's 128
  layer matmuls on the int8 tensor cores, every M=1 call on the GEMV);
- TinyLlama again on the ragged, chunked, long-generation path: batch 2
  with lengths (4096, 3000) right-padded to 4096,
  `prefill_compressed_chunked` in 4 chunks of 1024 (K1 mode (b)), then 383
  greedy steps over a 64-token ring and a decode pool of 4 blocks at 4
  bits, with 2 scale groups per head (K2 with the pool), so every layer
  flushes its ring 5 times and wraps the pool; counted once, timed
  twice, the uncompressed arm with the same lengths, and a profile;
- TinyLlama on the compressed-prefix chunked path: batch 2 uniform rows
  of 4096, `prefill_compressed_prefix_chunked` in 4 chunks of 1024 (each
  chunk attends over the compressed pools of the earlier ones: K1 mode (d)
  plus the diagonal pair, merged), then 127 greedy steps through K2 over
  the chunk-packed tiers; counted once, timed REPEATS_NEW times beside the
  full-buffer `prefill_compressed_chunked` at the same shape, and a
  profile;
- TinyLlama with query-guided importance (`importance_source` "query"
  and "both", window automatic: 256 at 4096, mass pooled over 20 keys)
  beside the prompt-scored arm: the one-shot prefill (K1 mode (a)) and
  127 greedy steps (K2) at batch 1, and the chunked prefill (K1 mode (b),
  window query rows buffered across chunks) at batch 2 with lengths (4096,
  3000), each arm counted once and timed REPEATS_NEW times in turns, the
  query mass alone per layer, and a profile of the query-scored prefill;
- Gemma-2B (18 layers, hidden 2048, 8 query heads over 1 kv head,
  head_dim 256, vocab 256000, GeGLU, (1 + w) norms, scaled embeddings,
  tied head), bf16 random weights from SEED, fused: TinyLlama's traffic
  (prompt 4096, batch 1, 128 new tokens, tiers 8/4/2), counted once, timed
  REPEATS_NEW times, the uncompressed arm, and a profile.

Before the full runs, each path's kernel path is checked against the plain
path in float32 at reduced depth (2 layers, full width; Gemma-2B too): equal
greedy tokens, for the chunked path also chunked against one-shot prefill, and
for the compressed-prefix path equal kept positions and a single chunk
against `prefill_compressed`; for query-guided scoring ("query", "both")
equal kept positions and tokens, and chunked against one-shot prefill up
to a near-tie swap. `select_tokens` with the exact greedy scan is timed
beside the default prefix at S=4096.
Any failed check exits nonzero. The last line is the device JSON; the line
before it lists every kernel.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.metadata
import json
import subprocess
import sys
import time

import torch

PKG = "realtime_kv_cache_compression_tpu_torch"
JAX_PKG = "realtime_kv_cache_compression_tpu"
KERNELS = {  # key: (wrapper module, wrapper name, source, TPU kernel)
    "K1": ("flash_prefill", "flash_prefill_with_prompt_mass",
           f"{PKG}/csrc/flash_prefill.cu",
           f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1b": ("flash_prefill", "flash_chunk_attention_with_prompt_mass",
            f"{PKG}/csrc/flash_prefill.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1c": ("flash_prefill", "flash_full_pair_attention",
            f"{PKG}/csrc/flash_prefill_pair.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1d": ("flash_prefill", "flash_positioned_attention",
            f"{PKG}/csrc/flash_prefill_positioned.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1p": ("flash_prefill", "flash_diagonal_pair_attention",
            f"{PKG}/csrc/flash_prefill.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K2": ("decode_attention", "fused_decode_attention",
           f"{PKG}/csrc/decode_attention.cu",
           f"{JAX_PKG}/ops/pallas/decode_attention.py:143"),
    "K3": ("int4_matmul", "int4_matmul", f"{PKG}/csrc/int4_matmul.cu",
           f"{JAX_PKG}/ops/pallas/int4_matmul.py:46"),
    "K4": ("int8_matmul", "int8_matmul", f"{PKG}/csrc/int8_matmul.cu",
           f"{JAX_PKG}/ops/pallas/int8_matmul.py:42"),
}

# Tolerances. float32 kernel vs float32 reference: summation order and
# exp2-vs-exp rounding; K1 within 1e-4, K2 within 1e-5, prompt mass within
# 1e-5, K3 within 1e-4 of max|reference| (sums over K up to 11008 in
# another order). bf16 outputs: both sides compute in float32 and round to
# bf16 once, so an element may differ by one bf16 ulp of its own magnitude;
# the limit is two ulps of |reference| per element, plus a floor for the
# float32 difference before rounding: 1e-5 for attention outputs, and for
# K3 the float32 limit itself (1e-4 of max|reference|), since an output
# near zero after cancelling large terms carries the float32 difference of
# those terms and a tiny ulp. K4 is integer arithmetic with one epilogue in
# the same order on both sides: equal bit for bit. K1's chunked mode and
# K2 with the decode pool and scale groups are held to the same limits, and
# so are K1's positioned and pair modes; their log-sum-exp within 1e-5 on
# rows that see a key (float32 on both sides), -inf on the others. A bf16
# K1 output is the exception: its tensor cores take the probabilities
# rounded to bf16 (as the TPU kernel does), so it is held against the
# plain version on float32 copies of its inputs to the port's
# `bf16_output_limit`: two ulps plus 2^-8 (sum_j p_j |v_j|) / l (the
# plain version on |v|) plus 1e-5.
TOL_K1_F32 = 1e-4
TOL_K2_F32 = 1e-5
TOL_MASS = 1e-5
TOL_LSE = 1e-5
TOL_LOGITS = 1e-4  # float32 kernel path vs plain path, prefill logits
TOL_K3_REL = 1e-4
BF16_ULPS = 2
BF16_FLOOR = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

SEED = 0
PROMPT = 4096
NEW_TOKENS = 128
REPEATS = 3  # the query path's prompt-scored arm times the same run 3 more
REPEATS_7B = 2
# Llama-2-7B fused matmul shapes (K, N): wqkv, wo, w_gateup, w_down.
SHAPES_7B = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))
LM_HEAD_7B = (4096, 32000)
K3_CHECK_ROWS = 512  # K3's plain version at M=4096 is compared on a slice
# The ragged, chunked, long-generation path.
LENGTHS = (4096, 3000)
CHUNK = 1024
RING = 64
POOL_BLOCKS = 4
POOL_BITS = 4
GROUP_SIZE = 32       # 2 scale groups per head at d=64
DECODE_STEPS = 383    # flushes at steps 64, 128, ..., 320: 5 per layer
REPEATS_NEW = 3
SWAP_TOL = 1e-5       # chunked vs one-shot: a kept-token swap at a tier
                      # boundary passes only between near-equal scores
# The compressed-prefix path (the chunk = T/4 layout of
# experiments/chunked_prefix_quality.py): B uniform rows of PROMPT tokens
# in chunks of CHUNK, no decode pool.
PREFIX_BATCH = 2
# Query-guided importance: the observation window automatic (W = T/16,
# 256 at T = 4096), its mass max-pooled over 20 keys (2 * payload + 4 at
# payload 8, as experiments/quality_demo.py sets it).
QUERY_POOL = 20
QUERY_SOURCES = ("prompt", "query", "both")
# The sampled decode (top_k 1 at this temperature must give greedy tokens).
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.1)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def wrapper(key: str):
    module, name = KERNELS[key][:2]
    return getattr(importlib.import_module(f"{PKG}.ops.cuda.{module}"), name)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_share(out: torch.Tensor, ref: torch.Tensor,
               floor: float = BF16_FLOOR) -> float:
    """Largest share of its limit that any element's error uses; the limit
    is BF16_ULPS bf16 ulps of |ref| plus `floor`. Passes at <= 1."""
    ref = ref.float()
    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8-bit significand
    err = (out.float() - ref).abs()
    return float((err / (BF16_ULPS * ulp + floor)).max())


def check_close(out, ref, tol, what: str, floor: float = BF16_FLOOR,
                ref_abs=None) -> float:
    """Checks `out` against `ref` (bf16: the per-element ulp limit with
    `floor`, or with `ref_abs` given, K1's `bf16_output_limit`; float32:
    `tol` absolute), logs the result and returns the max abs error."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import bf16_limit_share

    err = max_err(out, ref)
    peak = float(ref.float().abs().max())
    if out.dtype == torch.bfloat16 and ref_abs is not None:
        share = bf16_limit_share(out, ref, ref_abs)
        log(f"{what}: max abs err {err:.3e}, max|ref| {peak:.3e}, worst "
            f"element at {share:.3f} of its limit ({BF16_ULPS} bf16 ulps "
            f"+ 2^-8 sum p|v|/l + {floor:.0e})")
        check(share <= 1.0, what)
    elif out.dtype == torch.bfloat16:
        share = bf16_share(out, ref, floor)
        log(f"{what}: max abs err {err:.3e}, max|ref| {peak:.3e}, worst "
            f"element at {share:.3f} of its limit ({BF16_ULPS} bf16 ulps "
            f"+ {floor:.3e})")
        check(share <= 1.0, what)
    else:
        log(f"{what}: max abs err {err:.3e} (tol {tol:.3e}), max|ref| "
            f"{peak:.3e}")
        check(err <= tol, what)
    return err


def k1_refs(plain, q, k, v, *args, **kw):
    """A K1 wrapper's plain version on float32 copies of q, k, v, and its
    output with v replaced by |v| (the sum_j p_j |v_j| / l of the bf16
    limit). Returns (result, ref_abs)."""
    f = [x.float() for x in (q, k, v)]
    return plain(*f, *args, **kw), plain(f[0], f[1], f[2].abs(), *args,
                                         **kw)[0]


def log_speed(what: str, cost: dict) -> None:
    """Logs a bf16 K1 timing: kernel, plain, bound, the kernel's share of
    its bound and its factor against SDPA (n/a where SDPA refused)."""
    lib = cost["library_ms"]
    factor = "n/a" if lib is None else f"{cost['ms'] / lib:.2f}"
    log(f"{what} bf16: kernel {cost['ms']:.4f} ms, plain "
        f"{cost['plain_ms']:.4f} ms, bound {cost['bound_ms']:.4f} ms "
        f"({cost['bound_by']}), {cost['bound_ms'] / cost['ms']:.3f} of its "
        f"bound; SDPA {lib} ms (no prompt mass), kernel/SDPA {factor}")


def cuda_ms(fn, reps: int = 1):
    """(last result, mean milliseconds per call) of `reps` calls of `fn`,
    timed with CUDA events on the current stream."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def kernel_and_plain_ms(kernel, plain, reps: int):
    """Mean ms per call of a kernel and of its plain version, after a
    warm-up of each, timed in turns (plain, kernel, kernel, plain)."""
    kernel(), plain()
    p1, k1, k2, p2 = (cuda_ms(f, reps)[1]
                      for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def pool_bytes(pool) -> int:
    """Bytes one layer's decode pool holds."""
    return nbytes(pool.k_stored, pool.v_stored, pool.k_scale, pool.k_zp,
                  pool.v_scale, pool.v_zp, pool.positions, pool.valid,
                  pool.write_block)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> None:
    log(nvidia_smi_line())
    try:
        triton_version = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_version = "not installed"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"triton {triton_version}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")


# The tensor-core kernels phase_build holds to no spill and wgmma in SASS
# (HGMMA for bf16, IGMMA for int8): K1's bf16 instances (3 modes x 5 head
# dims), K3's bf16 prefill tile (one instance per k-steps per group
# partial: 1, 2, 4) and K4's int8 prefill tile (float32 and bf16 output).
TC_KERNELS = {"flash_tc_kernel": 15, "int4_tc_kernel": 3,
              "int8_tc_kernel": 2}


def phase_build() -> None:
    """Builds the kernels (one nvcc per source, in parallel), logs ptxas's
    registers, shared memory and spills, and every K1 instance's as the
    runtime reports them; checks that no tensor-core kernel (TC_KERNELS)
    spills and, where cuobjdump is present, that each instance holds wgmma
    instructions (HGMMA, IGMMA); logs each K2 instance's stack frame and
    spills (its parameter struct is __grid_constant__, so a runtime
    segment index reads it in place).
    """
    import shutil

    from realtime_kv_cache_compression_tpu_torch.ops.cuda import _build
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import kernel_instances

    t0 = time.perf_counter()
    kl = _build.load_library()
    log(f"build: {kl.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, one process per source, {kl.build_seconds:.1f} s)")
    entry, spills, k2_frames = "", [], []
    for line in kl.ptxas_log.splitlines():
        if "Compiling" in line:
            entry = line
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
        if "decode_attention_kernel" in entry and "stack frame" in line:
            k2_frames.append(line.strip())
        tc = [k for k in TC_KERNELS if k in entry]
        if (tc and "spill" in line
                and " 0 bytes spill stores, 0 bytes spill loads" not in line):
            spills.append(entry.split(tc[0])[1][:12] or tc[0])
    for row in kernel_instances():
        log(f"  K1 {row['mode']} {row['dtype']} d={row['head_dim']}: "
            f"{row['regs']} registers, {row['local_bytes']} B local "
            f"memory, {row['static_smem'] + row['dynamic_smem']} B shared "
            f"memory, {row['threads']} threads")
        if row["dtype"] == "bfloat16" and row["local_bytes"]:
            spills.append(f"{row['mode']} d={row['head_dim']}")
    check(not spills, f"tensor-core instances spill: {spills}")
    log(f"  K2 instances: {len(k2_frames)}; stack frames / spills: "
        f"{sorted(set(k2_frames))}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([cuobjdump, "-sass", str(kl.path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"cuobjdump not run ({e}): wgmma not checked")
        return
    hgmma = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if any(k in name for k in TC_KERNELS):
                hgmma[name] = 0
        elif name in hgmma and "GMMA" in line:
            hgmma[name] += 1
    for name, n in sorted(hgmma.items()):
        log(f"  SASS {name}: {n} HGMMA/IGMMA instructions")
    found = {k: sum(k in name for name in hgmma) for k in TC_KERNELS}
    check(found == TC_KERNELS and all(hgmma.values()),
          f"every tensor-core instance {TC_KERNELS} holds wgmma: {found}")


def _fused_qkv(gen, b, s, hq, hkv, d, dtype, device):
    """q, k, v as column slices of one fused projection [B, S, (Hq + 2 Hkv)
    D], strided as the main path's fused QKV hands them to K1."""
    qkv = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen,
                      device=device).to(dtype)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return (q.unflatten(-1, (hq, d)), k.unflatten(-1, (hkv, d)),
            v.unflatten(-1, (hkv, d)))


def phase_k1(device, shape, ragged=(2, 1000), reps: int = 10) -> dict:
    """K1 against its plain version on strided q/k/v: `shape` (B, S, Hq,
    Hkv, D) in bf16 (timed, with its bound and SDPA as the library
    yardstick) and float32, then a ragged S with per-row prompt lengths in
    both dtypes."""
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        prefill_attention_with_prompt_mass)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_prefill_with_prompt_mass

    gen = torch.Generator(device=device).manual_seed(SEED)
    b, s, hq, hkv, d = shape
    rb, rs = ragged
    plen = 128
    plens = torch.tensor([37, plen], dtype=torch.int32, device=device)[:rb]
    worst, timing = 0.0, None
    for (bb, ss, lens), dtype in (
            ((b, s, None), torch.bfloat16), ((b, s, None), torch.float32),
            ((rb, rs, plens), torch.bfloat16), ((rb, rs, plens),
                                                torch.float32)):
        q, k, v = _fused_qkv(gen, bb, ss, hq, hkv, d, dtype, device)
        check(not (q.is_contiguous() or v.is_contiguous()),
              "K1 inputs are strided slices")
        o, pm = flash_prefill_with_prompt_mass(q, k, v, plen,
                                               prompt_lens=lens)
        (o_ref, pm_ref), o_abs = k1_refs(prefill_attention_with_prompt_mass,
                                         q, k, v, plen, prompt_lens=lens)
        what = (f"K1 {tuple(q.shape)} {str(dtype)[6:]} plens "
                f"{plen if lens is None else lens.tolist()}")
        worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what + " out",
                                       ref_abs=o_abs),
                    check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
        del o_ref, pm_ref, o_abs
        if timing is None:  # the path's shape and dtype
            ms, plain_ms = kernel_and_plain_ms(
                lambda: flash_prefill_with_prompt_mass(q, k, v, plen),
                lambda: prefill_attention_with_prompt_mass(q, k, v, plen),
                reps)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                               enable_gqa=hq != hkv)
            lib()
            _, lib_ms = cuda_ms(lib, reps)
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      **bound(nbytes(q, k, v, o) + b * s * 4,
                              4 * b * hq * d * s * (s + 1) / 2, dtype)}
            log_speed(f"K1 mode a {tuple(q.shape)}", timing)
    return {"max_abs_err": worst, **timing}


def phase_k1_activations(device, mcfg, prompt: int = 1024) -> float:
    """bf16 K1 on the model's own activations: `mcfg` (TinyLlama at 2
    layers, full width) with bf16 random weights from SEED, one prompt of
    `prompt` tokens through `prefill_compressed` with a recording wrapper
    around K1 mode (a). Every call's output is held against the plain
    version on float32 copies of its own q, k, v under the bf16 limit, its
    prompt mass within TOL_MASS. Then the same prefill on the plain path
    (`use_flash=False`, bf16): the kept positions per layer and tier of
    the two are logged (bf16 rounding may move a token across a tier
    boundary, so they are read, not checked). Returns the largest error."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        prefill_attention_with_prompt_mass)

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    calls = []
    original = llama.flash_prefill_with_prompt_mass

    def recording(q, k, v, prompt_len, prompt_lens=None):
        result = original(q, k, v, prompt_len, prompt_lens=prompt_lens)
        calls.append((q, k, v, prompt_len, prompt_lens, result))
        return result

    llama.flash_prefill_with_prompt_mass = recording
    try:
        _, st_kernel, _ = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=16, use_flash=True)
    finally:
        llama.flash_prefill_with_prompt_mass = original
    check(len(calls) == mcfg.num_layers, "one K1 call per layer recorded")
    worst = 0.0
    for li, (q, k, v, plen, lens, (o, pm)) in enumerate(calls):
        check(q.dtype == torch.bfloat16, "the model's K1 calls are bf16")
        (o_ref, pm_ref), o_abs = k1_refs(prefill_attention_with_prompt_mass,
                                         q, k, v, plen, prompt_lens=lens)
        what = (f"K1 mode a on layer {li}'s own activations "
                f"{tuple(q.shape)} bf16")
        worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what + " out",
                                       ref_abs=o_abs),
                    check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
    del calls
    _, st_plain, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=16, use_flash=False)
    for li, (ck, cp) in enumerate(zip(st_kernel.caches, st_plain.caches)):
        moved = []
        for a, c in zip(ck.tiers, cp.tiers):
            ka = set(a.positions[0][a.valid[0]].tolist())
            kc = set(c.positions[0][c.valid[0]].tolist())
            moved.append(f"{len(ka - kc)} of {len(ka)}")
        log(f"bf16 prefill, K1 vs plain attention, layer {li}: kept "
            f"positions of the kernel path missing from the plain path's, "
            f"per tier (high, mid, low): {moved}")
    return worst


def phase_k2(device, mcfg, prompt: int = PROMPT, decode_steps: int = 5,
             reps: int = 20) -> dict:
    """K2 against dequantize + attention_over_tokens on real decode states:
    a full-width prefill at reduced depth, a few decode steps into the
    ring, then every layer's cache at 8/4/2 and at the anchor config's
    16/8/4 tiers, in bf16 (8/4/2 layer 0 timed, with its bound) and in
    float32. No single PyTorch call computes it (library_ms null)."""
    from realtime_kv_cache_compression_tpu_torch import (
        CompressionConfig, reference_anchor_config)
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    worst, timing = 0.0, None
    for dtype in ("bfloat16", "float32"):
        mcfg_d = dataclasses.replace(mcfg, dtype=dtype)
        params = llama.fuse_params(llama.init_params(SEED, mcfg_d, device))
        for name, ccfg in (
                ("8/4/2", CompressionConfig(num_layers=mcfg.num_layers)),
                ("16/8/4", reference_anchor_config(
                    num_layers=mcfg.num_layers))):
            logits, state, _ = llama.prefill_compressed(
                params, ids, mcfg_d, ccfg, max_decode_len=NEW_TOKENS)
            _, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                         state, decode_steps, mcfg_d, ccfg)
            q = torch.randn((1, 1, mcfg.num_heads, mcfg.head_dim),
                            generator=gen, device=device).to(
                                llama.model_dtype(mcfg_d))
            q_pos = state.position[:, None]
            for i, (cache, recent) in enumerate(zip(state.caches,
                                                    state.recents)):
                out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
                ref = decode_attention_plain(q, cache, recent, q_pos, ccfg)
                what = (f"K2 {name} {dtype} layer {i}: ring "
                        f"{int(recent.length[0])}/{recent.capacity}, tier "
                        f"capacities {[t.capacity for t in cache.tiers]}")
                worst = max(worst, check_close(out, ref, TOL_K2_F32, what))
            if timing is None:  # the path's dtype and tiers
                cache, recent = state.caches[0], state.recents[0]
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: fused_decode_attention(q, cache, recent, q_pos,
                                                   ccfg),
                    lambda: decode_attention_plain(q, cache, recent, q_pos,
                                                   ccfg), reps)
                n_ring = int(recent.length.sum())
                n_keys = sum(int(t.valid.sum()) for t in cache.tiers) + n_ring
                ring_bytes = 2 * n_ring * nbytes(recent.k[0, 0])
                timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          **bound(cache_storage_bytes(cache) + ring_bytes
                                  + 2 * nbytes(q),
                                  4 * mcfg.num_heads * mcfg.head_dim * n_keys,
                                  torch.bfloat16),
                          "device_us": _device_us_per_call(
                              lambda: fused_decode_attention(
                                  q, cache, recent, q_pos, ccfg),
                              match="decode")}
                log(f"K2 {name} {dtype} layer 0 ({n_keys} keys): kernel "
                    f"{ms:.4f} ms per call, device {timing['device_us']:.3f}"
                    f" us per call, plain {plain_ms:.4f} ms, bound "
                    f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
        del params
    return {"max_abs_err": worst, **timing}


def _pooled_ccfg(num_layers: int, group_size: int = GROUP_SIZE,
                 pool_bits: int = POOL_BITS,
                 blocks: int = POOL_BLOCKS):
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    return CompressionConfig(num_layers=num_layers,
                             quant_group_size=group_size,
                             decode_pool_blocks=blocks,
                             decode_pool_bits=pool_bits)


def phase_k1_chunk(device, shape, offsets=(0, 1024, 2048, 3072),
                   chunk: int = CHUNK, reps: int = 10) -> dict:
    """K1 mode (b) against `chunk_attention_with_prompt_mass`: batch 2 with
    the chunked path's per-row prompt lengths, `chunk` query rows (strided
    slices of one fused QKV, as the path hands them over) over a
    contiguous PROMPT-row K/V buffer at each chunk offset, bf16 and
    float32. Timed in bf16 at every offset with its bound (operations:
    4 B Hq d c (q_offset + (c + 1) / 2)) and SDPA with a boolean [c, S_k]
    causal mask as the library yardstick (no prompt mass); the returned
    numbers sum the offsets, one layer's chunked prefill."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        chunk_attention_with_prompt_mass)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_chunk_attention_with_prompt_mass

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    hq, hkv, d = shape
    b, s_k = len(LENGTHS), PROMPT
    ccfg = _pooled_ccfg(1)
    plen = ccfg.prompt_length(s_k)
    plens = llama._prompt_lens(torch.tensor(LENGTHS, device=device), ccfg,
                               plen)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, rows = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        k_buf, v_buf = (torch.randn((b, s_k, hkv, d), generator=gen,
                                    device=device).to(dtype)
                        for _ in range(2))
        for off in offsets:
            q = _fused_qkv(gen, b, chunk, hq, hkv, d, dtype, device)[0]
            kernel = lambda: flash_chunk_attention_with_prompt_mass(  # noqa
                q, k_buf, v_buf, off, plen, prompt_lens=plens)
            plain = lambda: chunk_attention_with_prompt_mass(  # noqa: E731
                q, k_buf, v_buf, off, plen, prompt_lens=plens)
            # The plain version rounds probabilities to the value dtype
            # before the value product, as the reference does, so the
            # kernel is held against it on exact float32 copies of the
            # same inputs.
            o, pm = kernel()
            (o_ref, pm_ref), o_abs = k1_refs(
                chunk_attention_with_prompt_mass, q, k_buf, v_buf, off, plen,
                prompt_lens=plens)
            what = (f"K1 mode b {tuple(q.shape)} over {s_k} keys at "
                    f"q_offset {off} {str(dtype)[6:]} plens {plens.tolist()}")
            worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what,
                                           ref_abs=o_abs),
                        check_close(pm, pm_ref, TOL_MASS,
                                    what + " prompt mass"))
            del o_ref, pm_ref, o_abs
            if dtype != torch.bfloat16:
                continue
            ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
            mask = (torch.arange(s_k, device=device)[None, :]
                    <= off + torch.arange(chunk, device=device)[:, None])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k_buf, v_buf))
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                               enable_gqa=hq != hkv)
            try:
                lib()
                lib_ms = cuda_ms(lib, reps)[1]
            except RuntimeError as e:  # the yardstick only; never the port
                lib_ms = None
                log(f"SDPA refused ({str(e)[:80]})")
            keys = off + chunk  # keys this chunk's rows can see
            cost = {"q_offset": off, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms,
                    **bound(nbytes(q, o) + 2 * b * keys * hkv * d
                            * k_buf.element_size() + b * chunk * 4,
                            4 * b * hq * d * chunk * (off + (chunk + 1) / 2),
                            dtype)}
            rows.append(cost)
            log_speed(f"K1 mode b {tuple(q.shape)} q_offset {off}", cost)
    return {"max_abs_err": worst, **_per_forward(rows, 1),
            "per_offset": rows}


def check_partial(part, refs, what: str) -> float:
    """A kernel's (o, lse, pm) partial against its plain version on float32
    copies, `refs` = (partial, ref_abs) from `k1_refs`: o and pm as
    `check_close` holds K1; lse within TOL_LSE on rows that see a key and
    -inf on both sides elsewhere. Returns the largest error."""
    (o, lse, pm), ((o_ref, lse_ref, pm_ref), o_abs) = part, refs
    err = max(check_close(o, o_ref, TOL_K1_F32, what + " out",
                          ref_abs=o_abs),
              check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
    sees = torch.isfinite(lse_ref)
    check(torch.equal(sees, torch.isfinite(lse))
          and bool((lse[~sees] == -torch.inf).all()),
          what + ": lse is -inf exactly on the rows that see no key")
    lse_err = max_err(lse[sees], lse_ref[sees]) if bool(sees.any()) else 0.0
    log(f"{what} lse: max abs err {lse_err:.3e} (tol {TOL_LSE:.0e}) on "
        f"{int(sees.sum())} rows that see a key, -inf on "
        f"{int((~sees).sum())}")
    check(lse_err <= TOL_LSE, what + " lse")
    return max(err, lse_err)


def _sdpa_ms(q, k, v, reps: int, **kw):
    """SDPA on the same inputs as the yardstick (never the port), or None
    where the installed PyTorch refuses it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: sdpa(qt, kt, vt, enable_gqa=qt.shape[1] != kt.shape[1],  # noqa
                       **kw)
    try:
        lib()
        return cuda_ms(lib, reps)[1]
    except RuntimeError as e:
        log(f"SDPA refused ({str(e)[:80]})")
        return None


def _prefix_pools(device, mcfg, gen):
    """Layer 0's dequantized pools and key positions (invalid slots at
    POS_SENTINEL) before each chunk of a real compressed-prefix prefill at
    mcfg's full width (its first layer, bf16 random weights from SEED,
    compressed as the path compresses layer 0: ratio 0.8, its largest
    pools): B = 2 rows of PROMPT tokens in chunks of CHUNK, tiers 8/4/2.
    Returns [(q_offset, k_pool, v_pool, kpos)]."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        dequantize_layer_cache)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import POS_SENTINEL

    cfg1 = dataclasses.replace(mcfg, num_layers=1,
                               max_position_embeddings=PROMPT + 512)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, cfg1, device))
    ids = torch.randint(0, mcfg.vocab_size, (PREFIX_BATCH, PROMPT),
                        generator=gen, device=device)
    st = llama.prefill_chunked_compressed_init(PREFIX_BATCH, PROMPT, CHUNK,
                                               cfg1, ccfg, device=device)
    pools = []
    for off in range(0, PROMPT, CHUNK):
        k_p, v_p, pos_p, valid_p = dequantize_layer_cache(
            st.caches[0], ccfg, torch.bfloat16)
        pools.append((off, k_p, v_p, torch.where(valid_p, pos_p,
                                                 POS_SENTINEL)))
        st = llama.prefill_chunked_compressed_step(
            params, ids[:, off:off + CHUNK], st, cfg1, ccfg, total_len=PROMPT)
    del params, st
    return pools


def phase_k1_prefix(device, mcfg, reps: int = 10) -> dict:
    """K1 mode (d) and the diagonal pair against their plain versions at the
    compressed-prefix path's shapes: B=2, CHUNK query rows (strided slices
    of one fused QKV) at each chunk offset, mode (d) over the pools a real
    prefill at mcfg's width leaves before that chunk (`_prefix_pools`, so N
    is the real slot count), the pair over the chunk's own K/V with its
    local prompt length. bf16 and float32 (exact float32 copies); timed in
    bf16 with bounds (operations 4 B Hq d c N_visible for mode (d), 4 B Hq
    d c (c + 1) / 2 for the pair) and SDPA as the yardstick (a boolean
    [c, N] mask from the positions; causal), without prompt mass. Returns
    both kernels' numbers summed over the offsets, one layer's prefill."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import (flash_diagonal_pair_attention, flash_positioned_attention,
                pair_attention_plain, positioned_attention_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    hq, hkv, d = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    b, c = PREFIX_BATCH, CHUNK
    plen = _pooled_ccfg(1).prompt_length(PROMPT)
    worst = {"positioned": 0.0, "pair": 0.0}
    rows = {"positioned": [], "pair": []}
    for off, k_p, v_p, kpos in _prefix_pools(device, mcfg, gen):
        n_vis = int((kpos <= off).sum())  # pool keys every row sees
        q, k_c, v_c = _fused_qkv(gen, b, c, hq, hkv, d, torch.bfloat16,
                                 device)
        plen_local = min(max(plen - off, 0), c)
        for dtype in (torch.bfloat16, torch.float32):
            qd, kpd, vpd, kcd, vcd = (t.to(dtype)
                                      for t in (q, k_p, v_p, k_c, v_c))
            kernels = {
                "positioned": (
                    lambda: flash_positioned_attention(  # noqa: E731
                        qd, kpd, vpd, kpos, off, plen),
                    lambda: positioned_attention_plain(  # noqa: E731
                        qd, kpd, vpd, kpos, off, plen),
                    lambda: k1_refs(  # noqa: E731
                        positioned_attention_plain, qd, kpd, vpd, kpos,
                        off, plen)),
                "pair": (
                    lambda: flash_diagonal_pair_attention(  # noqa: E731
                        qd, kcd, vcd, plen_local),
                    lambda: pair_attention_plain(  # noqa: E731
                        qd, kcd, vcd, plen_local, causal=True),
                    lambda: k1_refs(  # noqa: E731
                        pair_attention_plain, qd, kcd, vcd, plen_local,
                        causal=True)),
            }
            for name, (kernel, plain, refs) in kernels.items():
                what = (f"K1 {'mode d' if name == 'positioned' else 'pair'} "
                        f"{tuple(q.shape)} at q_offset {off} over "
                        f"{kpd.shape[1] if name == 'positioned' else c} keys "
                        f"({n_vis if name == 'positioned' else 'causal'} "
                        f"visible) {str(dtype)[6:]}")
                part = kernel()
                worst[name] = max(worst[name],
                                  check_partial(part, refs(), what))
                if dtype != torch.bfloat16:
                    continue
                ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
                o, lse, pm = part
                if name == "positioned":
                    mask = (kpos[:, None, None, :] <= off + torch.arange(
                        c, device=device)[None, None, :, None])
                    lib_ms = _sdpa_ms(qd, kpd, vpd, reps, attn_mask=mask)
                    cost = bound(nbytes(qd, o, kpos, lse, pm)
                                 + 2 * n_vis * hkv * d * 2,
                                 4 * hq * d * c * n_vis, dtype)
                else:
                    lib_ms = _sdpa_ms(qd, kcd, vcd, reps, is_causal=True)
                    cost = bound(nbytes(qd, kcd, vcd, o, lse, pm),
                                 4 * b * hq * d * c * (c + 1) / 2, dtype)
                cost.update(q_offset=off, n_slots=kpd.shape[1],
                            n_visible=n_vis, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms)
                rows[name].append(cost)
                log_speed(what.rsplit(" ", 1)[0], cost)
    return {name: {"max_abs_err": worst[name], **_per_forward(r, 1),
                   "per_offset": r} for name, r in rows.items()}


def phase_k1_full_pair(device, shape, s: int = CHUNK, reps: int = 10) -> dict:
    """K1 mode (c), the non-causal pair (ring attention's off-diagonal
    block, not on a path the port runs yet): B=2, S_q = S_k = s, strided q
    and contiguous K/V, per-row local prompt lengths, bf16 and float32;
    timed in bf16 with its bound (operations 4 B Hq d S_q S_k) and SDPA
    without a mask as the yardstick."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_full_pair_attention, pair_attention_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    hq, hkv, d = shape
    b = PREFIX_BATCH
    plen = torch.tensor([s // 4, 0], dtype=torch.int32, device=device)
    worst, timing = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        q = _fused_qkv(gen, b, s, hq, hkv, d, dtype, device)[0]
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=device)
                .to(dtype) for _ in range(2))
        kernel = lambda: flash_full_pair_attention(q, k, v, plen)  # noqa
        plain = lambda: pair_attention_plain(q, k, v, plen,  # noqa: E731
                                             causal=False)
        part = kernel()
        worst = max(worst, check_partial(
            part, k1_refs(pair_attention_plain, q, k, v, plen, causal=False),
            f"K1 mode c {tuple(q.shape)} over {s} keys {str(dtype)[6:]}"))
        if dtype != torch.bfloat16:
            continue
        ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
        o, lse, pm = part
        timing = {"ms": ms, "plain_ms": plain_ms,
                  "library_ms": _sdpa_ms(q, k, v, reps),
                  **bound(nbytes(q, k, v, o, lse, pm),
                          4 * b * hq * d * s * s, dtype)}
        log_speed(f"K1 mode c {tuple(q.shape)}", timing)
    return {"max_abs_err": worst, **timing}


def phase_k2_pool(device, mcfg, groups, prompt: int = PROMPT,
                  steps: int = 330, reps: int = 20) -> dict:
    """K2 with the decode pool and scale groups against
    `decode_attention_plain(pool=)` on real states at the chunked path's
    batch: a full-width ragged prefill of len(LENGTHS) rows with LENGTHS
    right-padded to `prompt` at reduced depth, then `steps` decode steps
    over a RING-token ring and POOL_BLOCKS pool blocks (past a pool wrap),
    so every row has its own positions and valid slots. 4- and 16-bit pools
    and each group count in `groups`, in bf16 and float32, every layer.
    The path's variant (4-bit pool, groups[-1] groups, bf16) is timed on
    layer 0 with its bound. No single PyTorch call computes it."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    b = len(LENGTHS)
    ids = torch.randint(0, mcfg.vocab_size, (b, prompt), generator=gen,
                        device=device)
    lengths = torch.tensor(LENGTHS, device=device)
    flushes = (steps - 1) // RING
    worst, timing = 0.0, None
    for dtype in ("bfloat16", "float32"):
        mcfg_d = dataclasses.replace(mcfg, dtype=dtype)
        params = llama.fuse_params(llama.init_params(SEED, mcfg_d, device))
        for bits in (POOL_BITS, 16):
            for g in reversed(groups):
                ccfg = _pooled_ccfg(mcfg.num_layers,
                                    0 if g == 1 else mcfg.head_dim // g,
                                    bits)
                logits, state, _ = llama.prefill_compressed(
                    params, ids, mcfg_d, ccfg, max_decode_len=RING,
                    lengths=lengths)
                _, state = llama.decode_loop(
                    params, torch.argmax(logits, -1), state, steps, mcfg_d,
                    ccfg)
                q = torch.randn((b, 1, mcfg.num_heads, mcfg.head_dim),
                                generator=gen, device=device).to(
                                    llama.model_dtype(mcfg_d))
                q_pos = state.position[:, None]
                check(state.position.tolist() == [n + steps
                                                  for n in LENGTHS],
                      "per-row decode positions")
                for i, (cache, recent, pool) in enumerate(zip(
                        state.caches, state.recents, state.pools)):
                    check(bool(pool.valid.all()) and pool.write_block.tolist()
                          == [flushes % POOL_BLOCKS] * b, "the pool wrapped")
                    out = fused_decode_attention(q, cache, recent, q_pos,
                                                 ccfg, pool=pool)
                    ref = decode_attention_plain(q, cache, recent, q_pos,
                                                 ccfg, pool=pool)
                    what = (f"K2 pool {bits}-bit G={g} {dtype} layer {i}, "
                            f"B={b} lengths {LENGTHS}: ring "
                            f"{recent.length.tolist()}/{RING}, pool "
                            f"{pool.capacity} tokens, {flushes} flushes")
                    worst = max(worst, check_close(out, ref, TOL_K2_F32,
                                                   what))
                if timing is not None:
                    continue
                cache, recent, pool = (state.caches[0], state.recents[0],
                                       state.pools[0])
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: fused_decode_attention(q, cache, recent, q_pos,
                                                   ccfg, pool=pool),
                    lambda: decode_attention_plain(q, cache, recent, q_pos,
                                                   ccfg, pool=pool), reps)
                n_ring = int(recent.length.sum())
                n_keys = (sum(int(t.valid.sum()) for t in cache.tiers)
                          + int(pool.valid.sum()) + n_ring)
                timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "variant": f"B={b} lengths {LENGTHS}, {bits}-bit "
                                     f"pool, G={g}, {dtype}",
                          **bound(cache_storage_bytes(cache)
                                  + pool_bytes(pool)
                                  + 2 * n_ring * nbytes(recent.k[0, 0])
                                  + 2 * nbytes(q),
                                  4 * mcfg.num_heads * mcfg.head_dim * n_keys,
                                  torch.bfloat16),
                          "device_us": _device_us_per_call(
                              lambda: fused_decode_attention(
                                  q, cache, recent, q_pos, ccfg, pool=pool),
                              match="decode")}
                log(f"K2 pool {bits}-bit G={g} {dtype} layer 0 ({n_keys} "
                    f"keys): kernel {ms:.4f} ms per call, device "
                    f"{timing['device_us']:.3f} us per call, plain "
                    f"{plain_ms:.4f} ms, bound {timing['bound_ms']:.4f} ms "
                    f"({timing['bound_by']})")
        del params
    return {"max_abs_err": worst, **timing}


def _int4_weight(gen, k, n, device):
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_tensor_int4
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    return quantize_tensor_int4(w, group_size=128)


def _int8_weight(gen, k, n, device):
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_tensor
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    return quantize_tensor(w, axis=1, act_quant=True)


def _per_forward(rows, layers: int, lm_head=None) -> dict:
    """One forward's worth of a kernel's calls: `layers` times each
    per-layer shape's numbers, plus lm_head's once (None stays None); bound_by
    names the limit of the calls that hold most of the summed bound."""
    parts = [(layers, r) for r in rows] + ([(1, lm_head)] if lm_head else [])
    tot = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [(n, r[key]) for n, r in parts]
        tot[key] = (None if any(v is None for _, v in vals)
                    else sum(n * v for n, v in vals))
    by_bytes = sum(n * r["bound_ms"] for n, r in parts
                   if r["bound_by"] == "bytes")
    tot["bound_by"] = ("bytes" if by_bytes >= tot["bound_ms"] / 2
                       else "operations")
    return tot


def _int4pack_library(w):
    """K3's function as one PyTorch call, for the yardstick only (the port
    never calls it): `torch._weight_int4pack_mm` dequantises a code u as
    (u - 8) * scale + zero (the layout of `_group_quantize_tensor` in
    torch/testing/_internal/common_quantization.py, zeros = min + 8 *
    scale), so zero = 0 gives K3's q * scale; its scales are bf16, K3's
    float32. The weight is repacked once, here: codes in K order [N, K],
    two per byte, even k in the high nibble. Returns a function of bf16 x;
    raises where the installed PyTorch refuses the shape."""
    p = w.q_packed.to(torch.int32)
    u = torch.cat([p & 0xF, p >> 4]).t().contiguous()  # [N, K], u = q + 8
    w_pk = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([w.scale, torch.zeros_like(w.scale)], -1).bfloat16()
    return lambda x: torch._weight_int4pack_mm(x, w_pk, w.group_size, sz)


def _device_us_per_call(fn, calls: int = 20, match: str = "") -> float:
    """Mean device microseconds per call of `fn` by torch.profiler: the
    kernels whose names hold `match` (every kernel with "") over `calls`
    calls after a warm-up. The CUDA-event time of back-to-back M=1 calls
    reads the host's enqueue as much as the card; this reads the card.
    The calls sit inside an idle margin of `pad` seconds at each end of
    the session: the profiler keeps only device events it places inside
    its window, and a session of a millisecond or two came back empty now
    and then after many sessions in one process (as if the card's clock
    had drifted off the host's). A session that records none of the
    kernels is run again with a ten times wider margin, up to three in
    all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    us = 0.0
    for attempt, pad in enumerate((0.1, 1.0, 10.0)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and match in e.name)
        if us > 0:
            break
        other = [e.name[:40] for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        log(f"profiler session {attempt + 1} (margin {pad} s) recorded no "
            f"'{match}' kernel; {len(other)} other device events "
            f"{other[:3]}")
    check(us > 0, f"the profiler saw device time of '{match}' kernels")
    return us / calls


def phase_k3(device, layers: int, prefill_m: int = PROMPT,
             reps: int = 20) -> dict:
    """K3 against its plain version at every fused Llama-2-7B matmul shape,
    M=1 and M=prefill_m (compared on the first K3_CHECK_ROWS rows), bf16
    and float32, each call on the route its shape and type take (M=1 the
    GEMV, bf16 M=prefill_m the tensor cores, float32 the scalar tile);
    timed in bf16 at both M with its bound, and torch._weight_int4pack_mm
    on the same codes (bf16 scales) as the library yardstick where it takes
    the shape; at M=1 also the device time per launch of both."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int4_matmul import (
        int4_matmul, int4_matmul_plain, int4_matmul_tensor)

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    worst, rows = 0.0, {1: [], prefill_m: []}
    for k, n in SHAPES_7B:
        w = _int4_weight(gen, k, n, device)
        plain = lambda x: int4_matmul_plain(  # noqa: E731
            x, w.q_packed, w.scale)
        try:
            lib, lib_refused = _int4pack_library(w), None
        except RuntimeError as e:  # the yardstick only; never the port
            lib, lib_refused = None, f"refused ({str(e)[:80]})"
        for dtype in (torch.bfloat16, torch.float32):
            for m in (1, prefill_m):
                x = torch.randn((m, k), generator=gen, device=device).to(dtype)
                before = dict(int4_matmul.route_launches)
                out = int4_matmul_tensor(x, w)
                route = ("gemv" if m == 1 else "tensor_core"
                         if dtype == torch.bfloat16 else "tile")
                check(int4_matmul.route_launches[route] == before[route] + 1,
                      f"K3 M={m} {dtype} takes the {route} route")
                r = min(m, K3_CHECK_ROWS)
                ref = plain(x[:r])
                tol = TOL_K3_REL * float(ref.float().abs().max())
                worst = max(worst, check_close(
                    out[:r], ref, tol, f"K3 M={m} (rows checked {r}) K={k} "
                    f"N={n} {str(dtype)[6:]}", floor=tol))
                del ref
                if dtype != torch.bfloat16:
                    continue
                reps_m = reps if m == 1 else 3
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: int4_matmul_tensor(x, w), lambda: plain(x),
                    reps_m)
                lib_ms, lib_note = None, lib_refused
                if lib is not None:
                    try:
                        lib_out = lib(x)
                        lib_ms = cuda_ms(lambda: lib(x), reps_m)[1]
                        lib_note = (
                            f"{lib_ms:.4f} ms, max abs diff from K3 "
                            f"{max_err(lib_out, out):.3e} (bf16 scales)")
                        del lib_out
                    except RuntimeError as e:
                        lib_note = f"refused ({str(e)[:80]})"
                cost = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **bound(nbytes(x, w.q_packed, w.scale, out),
                                2 * m * k * n, dtype)}
                device_note = ""
                if m == 1:
                    cost["device_us"] = _device_us_per_call(
                        lambda: int4_matmul_tensor(x, w), match="int4")
                    cost["library_device_us"] = (
                        None if lib_ms is None
                        else _device_us_per_call(lambda: lib(x)))
                    device_note = (
                        f"; device us per launch: kernel "
                        f"{cost['device_us']:.3f} (bound "
                        f"{cost['bound_ms'] * 1e3:.3f}), library "
                        f"{cost['library_device_us']}")
                rows[m].append(cost)
                log(f"K3 M={m} K={k} N={n} bf16: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                    f"({cost['bound_by']}, {cost['bound_ms'] / ms:.3f} of "
                    f"it reached); torch._weight_int4pack_mm {lib_note}"
                    f"{device_note}")
    decode, prefill = (_per_forward(rows[m], layers) for m in (1, prefill_m))
    device_us = {key: sum(r[key] for r in rows[1]) / len(rows[1])
                 if all(r[key] is not None for r in rows[1]) else None
                 for key in ("device_us", "library_device_us")}
    log(f"K3 per forward ({layers} layers x 4 matmuls): decode step "
        f"{decode}; prefill {prefill}, {prefill['bound_ms'] / prefill['ms']:.3f}"
        f" of its bound; M=1 device us per launch, mean of the 4 shapes: "
        f"{device_us}")
    return {"max_abs_err": worst, **decode, "m1_device_us": device_us,
            "per_layer_m1": rows[1], "prefill": prefill}


def phase_k4(device, layers: int, prefill_m: int = PROMPT,
             reps: int = 20) -> dict:
    """K4 against its plain version at every fused Llama-2-7B matmul shape
    and lm_head, M=1 and M=prefill_m, bf16 and float32 outputs: equal bit
    for bit, each call on the route its shape takes (M=1 the GEMV, M >
    SMALL_M the int8 tensor cores at these shapes). Timed in bf16 at both M
    with its bound; at M=1 also the GEMV's device time per launch. The
    library yardstick is torch._int_mm plus the same scaling, timed on the
    weights as the port keeps them ([K, N], N-contiguous) and on a K-major
    copy made once outside the timing (passed as its transposed view, the
    layout cuBLAS's int8 tensor-core kernels want); library_ms is the
    faster of the two."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul, int8_matmul_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    worst, rows = 0.0, {1: [], prefill_m: []}
    lm_head, routes = {}, {}
    for k, n in SHAPES_7B + (LM_HEAD_7B,):
        w = _int8_weight(gen, k, n, device)
        w_t = w.q.t().contiguous()  # K-major copy for the yardstick only
        for m in (1, prefill_m):
            x_q = torch.randint(-127, 128, (m, k), generator=gen,
                                device=device, dtype=torch.int8)
            x_s = torch.rand((m,), generator=gen, device=device) / 127 + 1e-4
            route = "gemv" if m == 1 else "tc"
            for dtype in (torch.bfloat16, torch.float32):
                before = dict(int8_matmul.route_launches)
                out = int8_matmul(x_q, w.q, x_s, w.scale, out_dtype=dtype)
                check(int8_matmul.route_launches[route] == before[route] + 1,
                      f"K4 M={m} K={k} N={n} {dtype} takes the {route} "
                      f"route")
                ref = int8_matmul_plain(x_q, w.q, x_s, w.scale,
                                        out_dtype=dtype)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(out.view(bits), ref.view(bits))
                err = max_err(out, ref)
                worst = max(worst, err)
                log(f"K4 M={m} K={k} N={n} {str(dtype)[6:]} ({route}): "
                    f"bit-equal {same}, max abs err {err:.3e}")
                check(same, f"K4 M={m} K={k} N={n} {dtype} bit for bit")
                del ref
            routes[f"M={m} K={k} N={n}"] = route
            reps_m = reps if m == 1 else 3
            ms, plain_ms = kernel_and_plain_ms(
                lambda: int8_matmul(x_q, w.q, x_s, w.scale),
                lambda: int8_matmul_plain(x_q, w.q, x_s, w.scale), reps_m)
            lib_ms = {}
            for layout, b_op in (("[K, N]", w.q), ("K-major", w_t.t())):
                lib = lambda: (  # noqa: E731
                    torch._int_mm(x_q, b_op).float() * x_s[:, None]
                    * w.scale[None, :]).bfloat16()
                try:
                    lib()
                    lib_ms[layout] = cuda_ms(lib, reps_m)[1]
                except RuntimeError as e:  # the yardstick only; never the port
                    lib_ms[layout] = f"refused ({str(e)[:60]})"
            timed = [v for v in lib_ms.values() if isinstance(v, float)]
            cost = {"ms": ms, "plain_ms": plain_ms,
                    "library_ms": min(timed) if timed else None,
                    "library_ms_by_layout": lib_ms, "route": route,
                    **bound(nbytes(x_q, w.q, x_s, w.scale) + m * n * 2,
                            2 * m * k * n, torch.int8)}
            device_note = ""
            if m == 1:
                cost["device_us"] = _device_us_per_call(
                    lambda: int8_matmul(x_q, w.q, x_s, w.scale),
                    match="int8")
                device_note = (f"; device us per launch {cost['device_us']:.3f}"
                               f" (bound {cost['bound_ms'] * 1e3:.3f})")
            if (k, n) == LM_HEAD_7B:
                lm_head[m] = cost
            else:
                rows[m].append(cost)
            log(f"K4 M={m} K={k} N={n} bf16 ({route}): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                f"({cost['bound_by']}, {cost['bound_ms'] / ms:.3f} of it "
                f"reached); torch._int_mm + scaling {lib_ms}{device_note}")
        del w, w_t
    # lm_head runs at M=1 in decode and in prefill (last position only).
    decode = _per_forward(rows[1], layers, lm_head[1])
    prefill = _per_forward(rows[prefill_m], layers, lm_head[1])
    lib_layouts = {
        layout: (None if any(not isinstance(r["library_ms_by_layout"][layout],
                                            float) for r in rows[prefill_m])
                 else layers * sum(r["library_ms_by_layout"][layout]
                                   for r in rows[prefill_m]))
        for layout in ("[K, N]", "K-major")}
    # library_ms of the prefill: the faster layout's layer matmuls (128
    # calls at M=prefill_m); lm_head's one M=1 call has no library call
    # (torch._int_mm refuses M=1) and is left out of it, so the kernel's
    # own time over the same 128 calls stands beside it.
    timed = [v for v in lib_layouts.values() if v is not None]
    prefill["library_ms"] = min(timed) if timed else None
    prefill["ms_layer_matmuls"] = layers * sum(r["ms"]
                                               for r in rows[prefill_m])
    gemv = [r["device_us"] for r in rows[1]] + [lm_head[1]["device_us"]]
    device_us = {"mean_4_shapes": sum(gemv[:4]) / 4, "lm_head": gemv[4],
                 "bound_mean_4_shapes": sum(r["bound_ms"] for r in rows[1])
                 * 1e3 / 4}
    log(f"K4 per forward ({layers} layers x 4 matmuls + lm_head): decode "
        f"step {decode}; prefill {prefill}, {prefill['bound_ms'] / prefill['ms']:.3f}"
        f" of its bound; library per prefill by weight layout (layer "
        f"matmuls) {lib_layouts}; GEMV device us per launch {device_us}; "
        f"lm_head at M={prefill_m} (not on the path) {lm_head[prefill_m]}")
    return {"max_abs_err": worst, **decode, "per_layer_m1": rows[1],
            "lm_head_m1": lm_head[1], "prefill": prefill,
            "prefill_library_by_layout": lib_layouts,
            "m1_device_us": device_us, "routes": routes}


def _quantized(params, arm: str):
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_params, quantize_params_streaming
    if arm == "int4":
        params = quantize_params_streaming(params, bits=4, group_size=128)
    elif arm == "w8a8":
        params = quantize_params(params, bits=8, act_quant=True)
    return llama.fuse_params(params)


def phase_parity(device, mcfg, arm: str = "raw", prompt: int = 1024,
                 new_tokens: int = 16):
    """Kernel path vs plain path in float32: equal greedy tokens. The raw
    arm runs its plain path on the card (use_flash / use_fused off); the
    quantized arms run theirs on the CPU, where every wrapper takes its
    plain version (the matmul wrappers have no switch)."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_to

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = _quantized(llama.init_params(SEED, mcfg, device), arm)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    runs = {}
    for kernels in (True, False):
        p, i, use = params, ids, kernels
        if arm != "raw" and not kernels:  # CPU tensors: plain versions
            p, i, use = params_to(params, "cpu"), ids.cpu(), None
        logits, state, _ = llama.prefill_compressed(
            p, i, mcfg, ccfg, max_decode_len=new_tokens, use_flash=use)
        tok = torch.argmax(logits, -1)
        toks, _ = llama.decode_loop(p, tok, state, new_tokens - 1, mcfg,
                                    ccfg, use_fused=use)
        runs[kernels] = (torch.cat([tok[:, None], toks], 1).cpu(), state,
                         logits.cpu())
    (tk, sk, lk), (tp, sp, lp) = runs[True], runs[False]
    for i, (ck, cp) in enumerate(zip(sk.caches, sp.caches)):
        agree = [float((a.positions.cpu() == b.positions.cpu()).float()
                       .mean()) if a.capacity else 1.0
                 for a, b in zip(ck.tiers, cp.tiers)]
        log(f"parity {arm} layer {i}: kept-position agreement per tier "
            f"(high, mid, low) {agree}")
    log(f"parity {arm} f32 ({mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, prompt {prompt}): prefill logits max err "
        f"{max_err(lk, lp):.3e}; tokens kernel {tk.tolist()} plain "
        f"{tp.tolist()}")
    check(torch.equal(tk, tp), f"greedy tokens of kernel and plain paths "
                               f"({arm})")


def _kept_swaps(caches_a, caches_b, masses, ccfg, lengths, s,
                qmasses=None) -> list:
    """Per layer, the tokens kept (per tier and row) by one prefill and not
    the other, with their importance scores from `masses` (and `qmasses`,
    the query masses, under query-guided scoring): [(layer, tier, row,
    tokens, scores, paired)]."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)

    plens = llama._prompt_lens(lengths, ccfg, ccfg.prompt_length(s))
    swaps = []
    for li, (ca, cb) in enumerate(zip(caches_a, caches_b)):
        scores = importance_scores(
            masses[li], li, s, ccfg.prompt_length(s), ccfg, lengths=lengths,
            prompt_lens=plens,
            query_mass=None if qmasses is None else qmasses[li])
        for ti, (ta, tb) in enumerate(zip(ca.tiers, cb.tiers)):
            for r in range(lengths.shape[0]):
                ka = set(ta.positions[r][ta.valid[r]].tolist())
                kb = set(tb.positions[r][tb.valid[r]].tolist())
                if ka != kb:
                    toks = sorted(ka ^ kb)
                    swaps.append((li, ti, r, toks,
                                  scores[r, toks].tolist(),
                                  len(ka - kb) == len(kb - ka)))
    return swaps


def phase_parity_chunked(device, mcfg, prompt: int = 1024,
                         lengths=(1024, 700), chunk: int = 256,
                         ring: int = 16, blocks: int = 2, steps: int = 64):
    """The chunked, pooled path in float32 at reduced depth (full width):
    ragged `lengths`, chunks of `chunk`, a `ring`-token ring and `blocks`
    4-bit pool blocks with 2 scale groups, `steps` greedy steps (3 flushes
    per layer and a wrap). Kernel path vs plain path (both on the card):
    equal tokens. Chunked vs one-shot prefill (kernel path): equal tokens,
    and equal kept positions and validity per layer, except a swap at a
    tier boundary between tokens whose scores lie within SWAP_TOL (the two
    prefills run float32 matmuls at other shapes), which is logged."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = _pooled_ccfg(mcfg.num_layers, mcfg.head_dim // 2, blocks=blocks)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    ids = torch.randint(0, mcfg.vocab_size, (len(lengths), prompt),
                        generator=gen, device=device)
    lens = torch.tensor(lengths, device=device)
    runs = {}
    for kernels in (True, False):
        st = llama._prefill_chunks(params, ids, mcfg, ccfg, chunk, lens,
                                   kernels)
        logits, state, _ = llama.prefill_chunked_finish(
            params, st, mcfg, ccfg, max_decode_len=ring, lengths=lens)
        masses, caches = st.masses, state.caches
        toks, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, steps, mcfg, ccfg,
                                        use_fused=kernels)
        check(int(state.pools[0].write_block[0])
              == ((steps - 1) // ring) % blocks, "chunked parity: pool wrap")
        runs[kernels] = (toks.cpu(), caches, masses, logits.cpu())
    (tk_, ck, mk, lk), (tp, _, _, lp) = runs[True], runs[False]
    log(f"parity chunked f32 ({mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, lengths {lengths}, chunk {chunk}, ring {ring}, "
        f"{blocks} pool blocks, G=2): prefill logits max err "
        f"{max_err(lk, lp):.3e}; tokens kernel {tk_.tolist()} plain "
        f"{tp.tolist()}")
    check(torch.equal(tk_, tp), "chunked path: greedy tokens of kernel and "
                                "plain paths")
    logits, state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=ring, lengths=lens)
    swaps = _kept_swaps(ck, state.caches, mk, ccfg, lens, prompt)
    for li, ti, r, toks, scores, paired in swaps:
        spread = max(scores) - min(scores)
        log(f"chunked vs one-shot: layer {li} tier {ti} row {r} swaps "
            f"tokens {toks} (scores {scores}, spread {spread:.3e})")
        check(paired and spread <= SWAP_TOL,
              "chunked vs one-shot kept positions (boundary swap rule)")
    t1, _ = llama.decode_loop(params, torch.argmax(logits, -1), state, steps,
                              mcfg, ccfg)
    log(f"chunked vs one-shot prefill: logits max err "
        f"{max_err(lk, logits.cpu()):.3e}, {len(swaps)} boundary swaps, "
        f"tokens "
        f"equal {torch.equal(t1.cpu(), tk_)}")
    check(torch.equal(t1.cpu(), tk_), "greedy tokens of chunked and one-shot "
                                      "prefill")


def _recording_compress(compress_layer_kv, records):
    """`compress_layer_kv` that records each call's layer, offset, mass,
    min-max and query mass (for the swap rule's scores), then compresses."""
    def compress(k, v, mass, li, ccfg, mcfg, **kw):
        records[(li, kw.get("shard_offset", 0))] = (
            mass, kw.get("minmax"), kw.get("query_mass"))
        return compress_layer_kv(k, v, mass, li, ccfg, mcfg, **kw)
    return compress


def phase_parity_prefix(device, mcfg, prompt: int = 1024, chunk: int = 256,
                        steps: int = 16):
    """The compressed-prefix path in float32 at reduced depth (full width):
    B=2, `prompt` tokens in chunks of `chunk`, `steps` greedy steps. Kernel
    path (K1 mode (d) + the diagonal pair, K2 over the chunk-packed tiers)
    vs plain path (dense positioned attention, plain decode), both on the
    card: logits within TOL_LOGITS, equal tokens, and equal kept positions
    per layer, except a swap at a tier boundary between tokens whose
    chunk-local scores lie within SWAP_TOL. Then one chunk of `prompt`
    tokens (kernel path) against `prefill_compressed`: logits within
    TOL_LOGITS and identical kept positions and validity."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    ids = torch.randint(0, mcfg.vocab_size, (PREFIX_BATCH, prompt),
                        generator=gen, device=device)
    plen = ccfg.prompt_length(prompt)
    runs, records = {}, {}
    original = llama.compress_layer_kv
    for kernels in (True, False):
        llama.compress_layer_kv = _recording_compress(
            original, records if kernels else {})
        try:
            logits, state, _ = llama.prefill_compressed_prefix_chunked(
                params, ids, mcfg, ccfg, chunk_size=chunk,
                max_decode_len=steps, use_flash=kernels)
        finally:
            llama.compress_layer_kv = original
        toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    steps, mcfg, ccfg, use_fused=kernels)
        runs[kernels] = (logits, state.caches, toks)
    (lk, ck, tk), (lp, cp, tp) = runs[True], runs[False]
    n_swaps = 0
    for li, (a, c) in enumerate(zip(ck, cp)):
        for ti, (ta, tc) in enumerate(zip(a.tiers, c.tiers)):
            for r in range(PREFIX_BATCH):
                ka = set(ta.positions[r][ta.valid[r]].tolist())
                kb = set(tc.positions[r][tc.valid[r]].tolist())
                if ka == kb:
                    continue
                toks_x = sorted(ka ^ kb)
                scores = []
                for t in toks_x:
                    off = t // chunk * chunk
                    mass, mm, _ = records[(li, off)]
                    scores.append(float(importance_scores(
                        mass, li, chunk, plen, ccfg, position_offset=off,
                        total_len=prompt, minmax=mm)[r, t - off]))
                spread = max(scores) - min(scores)
                n_swaps += 1
                log(f"prefix kernel vs plain: layer {li} tier {ti} row {r} "
                    f"swaps tokens {toks_x} (scores {scores}, spread "
                    f"{spread:.3e})")
                check(len(ka - kb) == len(kb - ka) and spread <= SWAP_TOL,
                      "prefix path kept positions (boundary swap rule)")
    log(f"parity prefix f32 ({mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, B={PREFIX_BATCH} x {prompt}, chunk {chunk}): "
        f"prefill logits max err {max_err(lk, lp):.3e}, {n_swaps} boundary "
        f"swaps; tokens kernel {tk.tolist()} plain {tp.tolist()}")
    check(max_err(lk, lp) <= TOL_LOGITS, "prefix path: logits of kernel and "
                                         "plain paths")
    check(torch.equal(tk, tp), "prefix path: greedy tokens of kernel and "
                               "plain paths")

    lg1, st1, _ = llama.prefill_compressed_prefix_chunked(
        params, ids, mcfg, ccfg, chunk_size=prompt, max_decode_len=steps)
    lg2, st2, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                           max_decode_len=steps)
    same = all(torch.equal(a.valid, c.valid) and all(
        torch.equal(torch.sort(a.positions[r][a.valid[r]])[0],
                    torch.sort(c.positions[r][c.valid[r]])[0])
        for r in range(PREFIX_BATCH))
        for x, y in zip(st1.caches, st2.caches)
        for a, c in zip(x.tiers, y.tiers))
    log(f"prefix path, one chunk of {prompt} vs prefill_compressed: logits "
        f"max err {max_err(lg1, lg2):.3e}, kept positions identical {same}")
    check(max_err(lg1, lg2) <= TOL_LOGITS and same,
          "single-chunk prefix path equals prefill_compressed")


def _query_ccfg(num_layers: int, source: str):
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    return CompressionConfig(num_layers=num_layers, importance_source=source,
                             query_window=0, query_mass_pool=QUERY_POOL)


def _kept_positions(caches) -> list:
    """Per layer, tier and row, the sorted kept positions."""
    return [[[sorted(t.positions[r][t.valid[r]].tolist())
              for r in range(t.positions.shape[0])] for t in c.tiers]
            for c in caches]


def phase_parity_query(device, mcfg, prompt: int = 1024,
                       lengths=(1024, 700), chunk: int = 256,
                       steps: int = 16):
    """Query-guided scoring in float32 at reduced depth (full width), for
    "query" and "both", ragged rows: the kernel path (K1 mode (a), K2)
    against the plain path, both on the card: equal greedy tokens and
    equal kept positions per layer, tier and row. Then the chunked prefill
    (kernel path, chunks of `chunk`, window rows buffered in `q_tails`)
    against the one-shot prefill: equal tokens, and equal kept positions
    except a swap at a tier boundary between tokens whose scores (from the
    recorded prompt and query masses) lie within SWAP_TOL."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    ids = torch.randint(0, mcfg.vocab_size, (len(lengths), prompt),
                        generator=gen, device=device)
    lens = torch.tensor(lengths, device=device)
    for source in QUERY_SOURCES[1:]:
        ccfg = _query_ccfg(mcfg.num_layers, source)
        runs = {}
        for kernels in (True, False):
            logits, state, _ = llama.prefill_compressed(
                params, ids, mcfg, ccfg, max_decode_len=steps, lengths=lens,
                use_flash=kernels)
            kept = _kept_positions(state.caches)
            toks, _ = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, steps, mcfg, ccfg,
                                        use_fused=kernels)
            runs[kernels] = (logits, kept, toks.cpu())
        (lk, kk, tk), (lp, kp, tp) = runs[True], runs[False]
        log(f"parity {source} f32 ({mcfg.num_layers} layers, hidden "
            f"{mcfg.hidden_size}, lengths {lengths}, W "
            f"{ccfg.query_window_for(prompt)}, pool {QUERY_POOL}): prefill "
            f"logits max err {max_err(lk, lp):.3e}; kept positions equal "
            f"{kk == kp}; tokens kernel {tk.tolist()} plain {tp.tolist()}")
        check(kk == kp, f"{source}: kept positions of kernel and plain paths")
        check(torch.equal(tk, tp), f"{source}: greedy tokens of kernel and "
                                   f"plain paths")

        records = {}
        original = llama.compress_layer_kv
        llama.compress_layer_kv = _recording_compress(original, records)
        try:
            logits, state, _ = llama.prefill_compressed_chunked(
                params, ids, mcfg, ccfg, chunk_size=chunk,
                max_decode_len=steps, lengths=lens)
        finally:
            llama.compress_layer_kv = original
        masses = [records[(li, 0)][0] for li in range(mcfg.num_layers)]
        qmasses = [records[(li, 0)][2] for li in range(mcfg.num_layers)]
        one_shot = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                            max_decode_len=steps,
                                            lengths=lens)[1]
        swaps = _kept_swaps(state.caches, one_shot.caches, masses, ccfg,
                            lens, prompt, qmasses)
        for li, ti, r, toks_x, scores, paired in swaps:
            spread = max(scores) - min(scores)
            log(f"{source} chunked vs one-shot: layer {li} tier {ti} row {r} "
                f"swaps tokens {toks_x} (scores {scores}, spread "
                f"{spread:.3e})")
            check(paired and spread <= SWAP_TOL,
                  f"{source}: chunked vs one-shot kept positions (boundary "
                  f"swap rule)")
        toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    steps, mcfg, ccfg)
        log(f"{source} chunked (chunk {chunk}) vs one-shot prefill: logits "
            f"max err {max_err(logits, lk):.3e}, {len(swaps)} boundary "
            f"swaps, tokens equal {torch.equal(toks.cpu(), tk)}")
        check(torch.equal(toks.cpu(), tk), f"{source}: greedy tokens of "
                                           f"chunked and one-shot prefill")


def _spread(xs) -> str:
    xs = sorted(xs)
    return (f"median {xs[len(xs) // 2]:.3f} (min {xs[0]:.3f}, max "
            f"{xs[-1]:.3f}; runs {', '.join(f'{x:.3f}' for x in xs)})")


def phase_main(label: str, device, mcfg, params, expect, prompt: int = PROMPT,
               new_tokens: int = NEW_TOKENS, repeats: int = REPEATS) -> dict:
    """One path at full width: counted once (the warm-up; every launch count
    set to 0 just before, read just after and held to `expect`, a dict of
    kernel key -> launches), then timed `repeats` times; then the
    uncompressed arm, timed the same way."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_bytes

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)  # tiers 8/4/2
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    n_steps = new_tokens - 1
    prefill = lambda: llama.prefill_compressed(  # noqa: E731
        params, ids, mcfg, ccfg, max_decode_len=new_tokens)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routed = [key for key in KERNELS
              if hasattr(wrapper(key), "route_launches")]
    for key in KERNELS:
        wrapper(key).launches = 0
    for key in routed:
        wrapper(key).route_launches = dict.fromkeys(
            wrapper(key).route_launches, 0)
    logits, state, stats = prefill()
    toks, state = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    n_steps, mcfg, ccfg)
    torch.cuda.synchronize()
    launches = {key: wrapper(key).launches for key in KERNELS}
    routes = {key: dict(wrapper(key).route_launches) for key in routed}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    summary = summarize_layer_stats(stats)
    log(f"{label} launches: {launches} (expect {expect}); by route "
        f"{routes}")
    check(launches == expect, f"{label}: launches per kernel")
    check(toks.shape == (1, n_steps) and bool(torch.isfinite(logits).all()),
          f"{label}: output shape and finite logits")
    check(0.0 < summary["avg_compression_ratio"] < 1.0,
          "kept ratio in (0, 1)")
    log(f"{label}: kept_ratio {summary['avg_compression_ratio']:.4f}, "
        f"byte_savings {summary['avg_memory_savings']:.4f}, params "
        f"{params_bytes(params) / 2**20:.1f} MB, peak memory {peak_mb:.1f} "
        f"MB")

    ttft, rate = [], []
    for _ in range(repeats):
        (logits, state, _), ms = cuda_ms(prefill)
        tok = torch.argmax(logits, -1)
        _, dec_ms = cuda_ms(lambda: llama.decode_loop(
            params, tok, state, n_steps, mcfg, ccfg))
        ttft.append(ms)
        rate.append(n_steps / (dec_ms / 1e3))
    log(f"{label} (compressed), {repeats} timed runs: TTFT ms "
        f"{_spread(ttft)}; decode tok/s {_spread(rate)}")

    # Uncompressed arm (its prefill runs K1 as well).
    pad = lambda a: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0, 0, 0, 0, new_tokens))
    pos = torch.full((1,), prompt, dtype=torch.int32, device=device)
    ttft_u, rate_u = [], []
    for i in range(repeats + 1):  # the first is a warm-up of 2 steps
        (lo, (ks, vs)), ms = cuda_ms(
            lambda: llama.prefill_uncompressed(params, ids, mcfg))
        tok, kv = torch.argmax(lo, -1), (pad(ks), pad(vs))
        del ks, vs
        _, dec_ms = cuda_ms(lambda: llama.decode_loop_uncompressed(
            params, tok, kv, pos, n_steps if i else 2, mcfg))
        del kv
        if i:
            ttft_u.append(ms)
            rate_u.append(n_steps / (dec_ms / 1e3))
    log(f"{label} (uncompressed arm), {repeats} timed runs: TTFT ms "
        f"{_spread(ttft_u)}; decode tok/s {_spread(rate_u)}")
    return {"launches": launches, "routes": routes, "params": params,
            "ids": ids, "ccfg": ccfg}


def _device_busy_ms(prof) -> float:
    """Milliseconds in which at least one kernel or copy ran on the card,
    from the profiler's device events (overlaps counted once)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def _profile_window(label: str, what: str, fn, top: int = 6) -> None:
    """torch.profiler over one call of `fn`: device busy time against host
    wall time (the profiler slows the host), and the kernels that take most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_ms(prof)
    log(f"profile {label} {what}: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, device idle share {1 - busy / wall:.4f}")
    check(busy > 0, f"profile {label} {what} saw device time")
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(kernels.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        log(f"  {t / 1e3:9.3f} ms  {n:5d} x  {name[:90]}")
    k1 = [(n, t) for name, (n, t) in kernels.items()
          if "flash_tc_kernel" in name or "flash_prefill_kernel" in name]
    if k1:
        log(f"  K1 in {label} {what}: {sum(t for _, t in k1) / 1e3:.3f} ms "
            f"of device time over {sum(n for n, _ in k1)} launches")


def phase_profile(label: str, mcfg, main_run, decode_steps: int = 10,
                  top: int = 6) -> None:
    """Where the time goes in a main run: torch.profiler over one
    compressed prefill and over `decode_steps` decode steps; device busy
    time against host wall time (the profiler slows the host), and the
    kernels that take most device time. Then `compress_layer_kv` of one
    layer alone, on the host clock."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        compress_layer_kv)
    from realtime_kv_cache_compression_tpu_torch.models import llama

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    logits, state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)
    tok = torch.argmax(logits, -1)
    _profile_window(label, "prefill", lambda: llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS), top)
    _profile_window(label, f"decode {decode_steps} steps",
                    lambda: llama.decode_loop(params, tok, state,
                                              decode_steps, mcfg, ccfg), top)

    gen = torch.Generator(device=ids.device).manual_seed(SEED + 4)
    b, s, hkv, d = 1, ids.shape[1], mcfg.num_kv_heads, mcfg.head_dim
    dt = llama.model_dtype(mcfg)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=ids.device)
            .to(dt) for _ in range(2))
    mass = torch.rand((b, s), generator=gen, device=ids.device)
    times = []
    for _ in range(6):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compress_layer_kv(k, v, mass, 0, ccfg, mcfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"compress_layer_kv alone ({label}), one layer, S={s}: host ms "
        f"{_spread(times[1:])}")


def run_7b_arm(arm: str, device, mcfg):
    """Llama-2-7B bf16 random weights from SEED, quantized for `arm`, fused;
    the main run with its launch counts, overall and by route (the prefill's
    128 layer matmuls on the tensor cores, every M=1 call on the GEMV), then
    a profile. Returns (launches, launches by route)."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = _quantized(llama.init_params(SEED, mcfg, device), arm)
    torch.cuda.synchronize()
    log(f"llama2-7b {arm}: init + quantize + fuse "
        f"{time.perf_counter() - t0:.1f} s")
    n_layers, n_steps = mcfg.num_layers, NEW_TOKENS - 1
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=n_layers, K2=n_layers * n_steps)
    if arm == "int4":
        key, tc = "K3", "tensor_core"
        expect[key] = 4 * n_layers * (1 + n_steps)
        gemv = 4 * n_layers * n_steps  # lm_head is int8 weight-only
    else:
        key, tc = "K4", "tc"
        expect[key] = (4 * n_layers + 1) * (1 + n_steps)
        gemv = (4 * n_layers + 1) * n_steps + 1  # + lm_head at prefill
    run = phase_main(f"llama2-7b {arm} main run", device, mcfg, params,
                     expect, repeats=REPEATS_7B)
    routes = run["routes"][key]
    check(routes == {"gemv": gemv, tc: 4 * n_layers, "tile": 0},
          f"llama2-7b {arm}: {key} launches by route {routes}")
    phase_profile(f"llama2-7b {arm}", mcfg, run)
    launches = run["launches"]
    del run, params
    torch.cuda.empty_cache()
    return launches, routes


def run_gemma(device, mcfg) -> dict:
    """Gemma-2B at full width and depth, bf16 random weights from SEED,
    fused: the main run with its launch counts (K1 and K2 only: no
    quantized weights), then a profile."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    torch.cuda.synchronize()
    log(f"gemma-2b: init + fuse {time.perf_counter() - t0:.1f} s")
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=mcfg.num_layers, K2=mcfg.num_layers * (NEW_TOKENS - 1))
    run = phase_main("gemma-2b main run", device, mcfg, params, expect,
                     repeats=REPEATS_NEW)
    phase_profile("gemma-2b", mcfg, run)
    launches = run["launches"]
    del run, params
    torch.cuda.empty_cache()
    return launches


def _host_ms(fn, runs: int = 6) -> list:
    """Host milliseconds of `runs - 1` calls of `fn` after a warm-up, each
    between two synchronizes."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def phase_chunked_path(device, mcfg, repeats: int = REPEATS_NEW) -> dict:
    """The ragged, chunked, long-generation path at full width and depth:
    batch 2 with LENGTHS right-padded to PROMPT, `prefill_compressed_chunked`
    in chunks of CHUNK (K1 mode (b)), DECODE_STEPS greedy steps over a
    RING-token ring and a POOL_BLOCKS x POOL_BITS-bit decode pool with 2
    scale groups (K2 with the pool). Counted once (launches and flushes per
    layer held exactly), timed `repeats` times, the uncompressed arm with
    the same lengths, the bf16 chunked-vs-one-shot kept-position reading,
    the flush's cost alone, and a profile whose decode window holds a
    flush."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes, flush_recent, init_decode_pool,
        init_recent_cache, summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama

    label = "tinyllama chunked pooled run"
    layers, n = mcfg.num_layers, DECODE_STEPS
    ccfg = _pooled_ccfg(layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    b = len(LENGTHS)
    ids = torch.randint(0, mcfg.vocab_size, (b, PROMPT), generator=gen,
                        device=device)
    lengths = torch.tensor(LENGTHS, device=device)
    prefill = lambda: llama.prefill_compressed_chunked(  # noqa: E731
        params, ids, mcfg, ccfg, chunk_size=CHUNK, max_decode_len=RING,
        lengths=lengths)

    flushes = {}

    def counting_flush(recent, pool, *args):
        flushes[id(pool)] = flushes.get(id(pool), 0) + 1
        return flush_recent(recent, pool, *args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in KERNELS:
        wrapper(key).launches = 0
    llama.flush_recent = counting_flush
    try:
        logits, state, stats = prefill()
        toks, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, n, mcfg, ccfg)
        torch.cuda.synchronize()
    finally:
        llama.flush_recent = flush_recent
    launches = {key: wrapper(key).launches for key in KERNELS}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    expect = {key: 0 for key in KERNELS}
    expect.update(K1b=layers * PROMPT // CHUNK, K2=layers * n)
    per_layer = [flushes.get(id(p), 0) for p in state.pools]
    log(f"{label} launches: {launches} (expect {expect}); flushes per "
        f"layer {per_layer} (expect {(n - 1) // RING})")
    check(launches == expect, f"{label}: launches per kernel")
    check(per_layer == [(n - 1) // RING] * layers, f"{label}: flushes")
    check(all(bool(p.valid.all()) and int(p.write_block[0])
              == ((n - 1) // RING) % POOL_BLOCKS for p in state.pools),
          f"{label}: every pool wrapped")
    check(toks.shape == (b, n) and bool(torch.isfinite(logits).all()),
          f"{label}: output shape and finite logits")
    summary = summarize_layer_stats(stats)
    check(0.0 < summary["avg_compression_ratio"] < 1.0,
          "kept ratio in (0, 1)")
    stored = sum(cache_storage_bytes(c) + pool_bytes(p)
                 + nbytes(r.k, r.v, r.positions, r.length)
                 for c, p, r in zip(state.caches, state.pools,
                                    state.recents))
    dense = (layers * 2 * (sum(LENGTHS) + b * n) * mcfg.num_kv_heads
             * mcfg.head_dim * 2)
    log(f"{label}: kept_ratio {summary['avg_compression_ratio']:.4f}, "
        f"byte_savings (prefill tiers) {summary['avg_memory_savings']:.4f}; "
        f"after {n} steps tiers + pools + rings hold {stored / 2**20:.3f} "
        f"MB against {dense / 2**20:.3f} MB of bf16 K/V for the "
        f"{sum(LENGTHS) + b * n} tokens (savings {1 - stored / dense:.4f}); "
        f"peak memory {peak_mb:.1f} MB")

    ttft, rate = [], []
    for _ in range(repeats):
        (logits, state, _), ms = cuda_ms(prefill)
        tok = torch.argmax(logits, -1)
        _, dec_ms = cuda_ms(lambda: llama.decode_loop(
            params, tok, state, n, mcfg, ccfg))
        ttft.append(ms)
        rate.append(b * n / (dec_ms / 1e3))
    log(f"{label} (compressed), {repeats} timed runs: chunked-prefill TTFT "
        f"ms {_spread(ttft)}; decode tok/s (both rows) {_spread(rate)}")

    pad = lambda a: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0, 0, 0, 0, n))
    pos = lengths.to(torch.int32)
    ttft_u, rate_u = [], []
    for i in range(repeats + 1):  # the first is a warm-up of 2 steps
        (lo, (ks, vs)), ms = cuda_ms(lambda: llama.prefill_uncompressed(
            params, ids, mcfg, lengths=lengths))
        tok, kv = torch.argmax(lo, -1), (pad(ks), pad(vs))
        del ks, vs
        _, dec_ms = cuda_ms(lambda: llama.decode_loop_uncompressed(
            params, tok, kv, pos, n if i else 2, mcfg))
        del kv
        if i:
            ttft_u.append(ms)
            rate_u.append(b * n / (dec_ms / 1e3))
    log(f"{label} (uncompressed arm, same lengths), {repeats} timed runs: "
        f"TTFT ms {_spread(ttft_u)}; decode tok/s {_spread(rate_u)}")

    # Reading, not a check: bf16 chunked vs one-shot kept positions.
    _, chunked, _ = prefill()
    _, one_shot, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=RING, lengths=lengths)
    differ = [li for li, (a, c) in enumerate(zip(chunked.caches,
                                                 one_shot.caches))
              if any(not torch.equal(ta.positions, tc.positions)
                     for ta, tc in zip(a.tiers, c.tiers))]
    log(f"{label}: bf16 chunked vs one-shot prefill, layers whose kept "
        f"positions differ: {len(differ)} of {layers} {differ}")
    del chunked, one_shot

    # The flush alone: one layer's full ring into its pool.
    recent = init_recent_cache(b, RING, mcfg, device=device)
    recent.k.normal_(generator=gen)
    recent.v.normal_(generator=gen)
    pool = init_decode_pool(b, RING, ccfg, mcfg, device=device)

    def one_flush():
        recent.length.fill_(RING)
        flush_recent(recent, pool, ccfg, mcfg)

    times = _host_ms(one_flush)
    med = sorted(times)[len(times) // 2]
    log(f"flush_recent alone, one layer (B={b}, ring {RING}, "
        f"{POOL_BITS}-bit, G=2): host ms {_spread(times)}; per decode step "
        f"over {layers} layers, one flush every {RING} steps: "
        f"{med * layers / RING:.3f} ms")

    logits, state, _ = prefill()
    tok = torch.argmax(logits, -1)
    _profile_window("tinyllama chunked", "chunked prefill", prefill)
    toks, state = llama.decode_loop(params, tok, state, RING - 4, mcfg, ccfg)
    _profile_window("tinyllama chunked",
                    "decode 10 steps (a flush at the 5th)",
                    lambda: llama.decode_loop(params, toks[:, -1], state, 10,
                                              mcfg, ccfg))
    del params, state
    torch.cuda.empty_cache()
    return launches


def _kept_and_stored(caches, layers: int, b: int, s: int, mcfg):
    """(kept ratio from the tiers' `valid`, stored tier bytes, dense bf16
    K/V bytes of the same b x s tokens)."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)

    kept = sum(int(t.valid.sum()) for c in caches for t in c.tiers)
    stored = sum(cache_storage_bytes(c) for c in caches)
    dense = layers * 2 * b * s * mcfg.num_kv_heads * mcfg.head_dim * 2
    return kept / (layers * b * s), stored, dense


def phase_prefix_path(device, mcfg, repeats: int = REPEATS_NEW) -> dict:
    """The compressed-prefix chunked path at full width and depth:
    PREFIX_BATCH uniform rows of PROMPT tokens, `prefill_compressed_prefix_
    chunked` in chunks of CHUNK (K1 mode (d) over the pools plus the
    diagonal pair, merged), NEW_TOKENS - 1 greedy steps through K2 over the
    chunk-packed tiers, no decode pool. Counted once (launches held
    exactly), K2 held against its plain version on that state's first and
    last layers, then timed `repeats` times in turns with the full-buffer
    `prefill_compressed_chunked` at the same shape (TTFT, decode rate, kept
    ratio from the tiers' `valid`, stored bytes, peak memory of each), and
    a profile with `compress_layer_kv`'s host time per chunk and layer."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        compress_layer_kv)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    label = "tinyllama compressed-prefix run"
    layers, n = mcfg.num_layers, NEW_TOKENS - 1
    b = PREFIX_BATCH
    ccfg = CompressionConfig(num_layers=layers)  # tiers 8/4/2
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    ids = torch.randint(0, mcfg.vocab_size, (b, PROMPT), generator=gen,
                        device=device)
    forms = {
        "prefix": lambda: llama.prefill_compressed_prefix_chunked(  # noqa
            params, ids, mcfg, ccfg, chunk_size=CHUNK,
            max_decode_len=NEW_TOKENS),
        "full-buffer": lambda: llama.prefill_compressed_chunked(  # noqa
            params, ids, mcfg, ccfg, chunk_size=CHUNK,
            max_decode_len=NEW_TOKENS),
    }
    readings = {}
    for form, prefill in forms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for key in KERNELS:
            wrapper(key).launches = 0
        logits, state, _ = prefill()
        toks, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, n, mcfg, ccfg)
        torch.cuda.synchronize()
        launches = {key: wrapper(key).launches for key in KERNELS}
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        check(toks.shape == (b, n) and bool(torch.isfinite(logits).all()),
              f"{label} ({form}): output shape and finite logits")
        kept, stored, dense = _kept_and_stored(state.caches, layers, b,
                                               PROMPT, mcfg)
        check(0.0 < kept < 1.0, f"{form}: kept ratio in (0, 1)")
        readings[form] = {"launches": launches, "kept_ratio": kept,
                          "stored_mb": stored / 2**20, "peak_mb": peak_mb,
                          "ttft_ms": [], "tok_s": []}
        log(f"{label} ({form} prefill): launches {launches}; kept_ratio "
            f"{kept:.4f}; tiers hold {stored / 2**20:.3f} MB against "
            f"{dense / 2**20:.3f} MB of dense bf16 K/V (savings "
            f"{1 - stored / dense:.4f}); peak memory {peak_mb:.1f} MB")
        expect = {key: 0 for key in KERNELS}
        expect.update({"K1d": layers * PROMPT // CHUNK,
                       "K1p": layers * PROMPT // CHUNK} if form == "prefix"
                      else {"K1b": layers * PROMPT // CHUNK}, K2=layers * n)
        log(f"{label} ({form}) launches: expect {expect}")
        check(launches == expect, f"{label} ({form}): launches per kernel")
        if form == "prefix":
            # K2 over the chunk-packed tiers at the full shape.
            q = torch.randn((b, 1, mcfg.num_heads, mcfg.head_dim),
                            generator=gen, device=device).bfloat16()
            q_pos = state.position[:, None]
            for li in (0, layers - 1):
                cache, recent = state.caches[li], state.recents[li]
                check_close(
                    fused_decode_attention(q, cache, recent, q_pos, ccfg),
                    decode_attention_plain(q, cache, recent, q_pos, ccfg),
                    TOL_K2_F32, f"K2 over the chunk-packed tiers, layer {li} "
                                f"(tier chunks {[t.chunk for t in cache.tiers]}"
                                f", capacities "
                                f"{[t.capacity for t in cache.tiers]})")
        del logits, state, toks

    for _ in range(repeats):
        for form, prefill in forms.items():
            (logits, state, _), ms = cuda_ms(prefill)
            tok = torch.argmax(logits, -1)
            _, dec_ms = cuda_ms(lambda: llama.decode_loop(
                params, tok, state, n, mcfg, ccfg))
            readings[form]["ttft_ms"].append(ms)
            readings[form]["tok_s"].append(b * n / (dec_ms / 1e3))
            del logits, state
    for form, r in readings.items():
        log(f"{label} ({form} prefill, B={b} x {PROMPT}, chunks of {CHUNK}),"
            f" {repeats} timed runs: TTFT ms {_spread(r['ttft_ms'])}; decode "
            f"tok/s (both rows) {_spread(r['tok_s'])}")

    prefill = forms["prefix"]
    logits, state, _ = prefill()
    tok = torch.argmax(logits, -1)
    _profile_window("tinyllama prefix", "compressed-prefix prefill", prefill)
    _profile_window("tinyllama prefix", "decode 10 steps",
                    lambda: llama.decode_loop(params, tok, state, 10, mcfg,
                                              ccfg))
    hkv, d = mcfg.num_kv_heads, mcfg.head_dim
    k, v = (torch.randn((b, CHUNK, hkv, d), generator=gen, device=device)
            .bfloat16() for _ in range(2))
    mass = torch.rand((b, CHUNK), generator=gen, device=device)
    mm = (mass.amin(-1, keepdim=True), mass.amax(-1, keepdim=True))
    times = _host_ms(lambda: compress_layer_kv(
        k, v, mass, 0, ccfg, mcfg, shard_offset=3 * CHUNK, total_len=PROMPT,
        minmax=mm))
    log(f"compress_layer_kv alone (tinyllama prefix), one chunk of {CHUNK} "
        f"and one layer, B={b}: host ms {_spread(times)}")
    del params, state
    torch.cuda.empty_cache()
    return readings["prefix"]["launches"]


def _counted_run(label: str, prefill, decode, expect: dict):
    """One prefill and decode with every launch count set to 0 just before
    and read just after, held to `expect`; returns (logits, prefill stats,
    tokens, launches, peak MB, the prefill's kept positions, the decode's
    ms by CUDA events)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in KERNELS:
        wrapper(key).launches = 0
    logits, state, stats = prefill()
    (toks, state), dec_ms = cuda_ms(lambda: decode(logits, state))
    launches = {key: wrapper(key).launches for key in KERNELS}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    log(f"{label} launches: {launches} (expect {expect})")
    check(launches == expect, f"{label}: launches per kernel")
    check(bool(torch.isfinite(logits).all()), f"{label}: finite logits")
    return (logits, stats, toks, launches, peak_mb,
            _kept_positions(state.caches), dec_ms)


def phase_query_path(device, mcfg, repeats: int = REPEATS_NEW) -> dict:
    """Query-guided importance at full width and depth, beside the
    prompt-scored arm: `importance_source` "prompt", "query" and "both"
    (window automatic, W = 256 at T = PROMPT; pool QUERY_POOL), on the
    one-shot path (prompt PROMPT, batch 1, NEW_TOKENS - 1 greedy steps;
    K1 mode (a), K2) and the chunked path (batch 2 with LENGTHS
    right-padded to PROMPT, chunks of CHUNK; K1 mode (b), K2). Each arm is
    counted once (launches held exactly; kept ratio, byte savings, peak
    memory), then timed `repeats` times with the arms in turns (TTFT, and
    on the one-shot path decode tok/s; the chunked form's decode tok/s is
    its counted run's); the query mass alone is timed per layer on the
    host clock after a sync; a profile of the query-scored one-shot
    prefill. Returns the launches per path."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        query_attention_mass, window_attention_mass)

    layers, n = mcfg.num_layers, NEW_TOKENS - 1
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ids1 = torch.randint(0, mcfg.vocab_size, (1, PROMPT), generator=gen,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    ids2 = torch.randint(0, mcfg.vocab_size, (len(LENGTHS), PROMPT),
                         generator=gen, device=device)
    lengths = torch.tensor(LENGTHS, device=device)
    forms = {
        "one-shot": (ids1, dict(), {"K1": layers}),
        "chunked": (ids2, dict(lengths=lengths),
                    {"K1b": layers * PROMPT // CHUNK}),
    }
    launches = {}
    for form, (ids, kw, k1) in forms.items():
        b = ids.shape[0]
        arms = {}
        for source in QUERY_SOURCES:
            ccfg = _query_ccfg(layers, source)
            if form == "one-shot":
                prefill = (lambda c=ccfg: llama.prefill_compressed(
                    params, ids, mcfg, c, max_decode_len=NEW_TOKENS))
            else:
                prefill = (lambda c=ccfg: llama.prefill_compressed_chunked(
                    params, ids, mcfg, c, chunk_size=CHUNK,
                    max_decode_len=NEW_TOKENS, **kw))
            decode = (lambda lo, st, c=ccfg: llama.decode_loop(
                params, torch.argmax(lo, -1), st, n, mcfg, c))
            label = f"tinyllama {source} {form}"
            expect = {key: 0 for key in KERNELS}
            expect.update(k1, K2=layers * n)
            logits, stats, toks, counted, peak, kept, dec_ms = _counted_run(
                label, prefill, decode, expect)
            check(toks.shape == (b, n), f"{label}: output shape")
            if source == "prompt":
                kept_prompt = kept
            else:
                shared = sum(len(set(x) & set(y)) for lx, ly in zip(
                    kept, kept_prompt) for tx, ty in zip(lx, ly)
                    for x, y in zip(tx, ty))
                total = sum(len(x) for lx in kept for tx in lx for x in tx)
                log(f"{label}: {shared / total:.4f} of the kept (position, "
                    f"tier) pairs are the prompt-scored arm's")
            summary = summarize_layer_stats(stats)
            check(0.0 < summary["avg_compression_ratio"] < 1.0,
                  f"{label}: kept ratio in (0, 1)")
            if source != "prompt":
                suffix = "" if form == "one-shot" else "_chunked"
                launches[f"tinyllama_{source}{suffix}"] = counted
            arms[source] = dict(prefill=prefill, decode=decode, ttft=[],
                                rate=[b * n / (dec_ms / 1e3)],
                                summary=summary, peak=peak)
        # The arms in turns, the order reversed each time. The chunked
        # form times its prefill only: its decode tok/s is the counted
        # run's (one reading), which keeps the script near half its limit.
        timed_decode = form == "one-shot"
        for i in range(repeats):
            order = QUERY_SOURCES if i % 2 == 0 else QUERY_SOURCES[::-1]
            for source in order:
                arm = arms[source]
                (logits, state, _), ms = cuda_ms(arm["prefill"])
                arm["ttft"].append(ms)
                if timed_decode:
                    _, dec_ms = cuda_ms(lambda: arm["decode"](logits, state))
                    arm["rate"].append(b * n / (dec_ms / 1e3))
                del state
        for source in QUERY_SOURCES:
            arm = arms[source]
            rates = arm["rate"][1:] if timed_decode else arm["rate"]
            log(f"tinyllama {source} {form} (B={b}): TTFT ms "
                f"{_spread(arm['ttft'])}; decode tok/s (all rows"
                f"{'' if timed_decode else ', the counted run'}) "
                f"{_spread(rates)}; kept_ratio "
                f"{arm['summary']['avg_compression_ratio']:.4f}, "
                f"byte_savings {arm['summary']['avg_memory_savings']:.4f}, "
                f"peak memory {arm['peak']:.1f} MB")
        del arms

    # The query mass alone, one layer, on each form's shapes.
    w = _query_ccfg(layers, "query").query_window_for(PROMPT)
    dt = llama.model_dtype(mcfg)
    hq, hkv, d = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    q = torch.randn((1, PROMPT, hq, d), generator=gen, device=device).to(dt)
    k = torch.randn((1, PROMPT, hkv, d), generator=gen, device=device).to(dt)
    one = _host_ms(lambda: query_attention_mass(q, k, w, pool=QUERY_POOL))
    b = len(LENGTHS)
    tails = torch.randn((b, w, hq, d), generator=gen, device=device).to(dt)
    k_buf = torch.randn((b, PROMPT, hkv, d), generator=gen,
                        device=device).to(dt)
    tail_pos = llama._tail_positions(b, w, PROMPT, lengths, device)
    key_ok = torch.arange(PROMPT, device=device)[None] < lengths[:, None]
    fin = _host_ms(lambda: window_attention_mass(
        tails, tail_pos.clamp(min=0), tail_pos >= 0, k_buf, key_ok,
        pool=QUERY_POOL))
    log(f"query mass alone, one layer, W={w}, pool {QUERY_POOL}: one-shot "
        f"(B=1, S={PROMPT}) host ms {_spread(one)}; chunked finish (B={b}) "
        f"host ms {_spread(fin)}; per prefill over {layers} layers "
        f"{sorted(one)[len(one) // 2] * layers:.3f} / "
        f"{sorted(fin)[len(fin) // 2] * layers:.3f} ms")
    del q, k, tails, k_buf

    ccfg = _query_ccfg(layers, "query")
    _profile_window("tinyllama query", "one-shot prefill",
                    lambda: llama.prefill_compressed(
                        params, ids1, mcfg, ccfg, max_decode_len=NEW_TOKENS))
    del params
    torch.cuda.empty_cache()
    return launches


def phase_exact_greedy(device, s: int = PROMPT, layer: int = 1) -> None:
    """`select_tokens` with selection_mode "exact_greedy" (a sequential
    scan, one step per sorted column) against the default "topk_prefix" on
    one layer's scores at S=`s`, B=1, host ms after a sync (the first call
    of each is the warm-up)."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)
    from realtime_kv_cache_compression_tpu_torch.ops.quantization import (
        assign_precision)
    from realtime_kv_cache_compression_tpu_torch.ops.selection import (
        select_tokens)

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    mass = torch.rand((1, s), generator=gen, device=device)
    times, kept = {}, {}
    for mode in ("topk_prefix", "exact_greedy"):
        ccfg = CompressionConfig(num_layers=22, selection_mode=mode)
        scores = importance_scores(mass, layer, s, ccfg.prompt_length(s),
                                   ccfg)
        labels, _ = assign_precision(scores, ccfg)
        times[mode] = _host_ms(
            lambda: select_tokens(scores, labels, layer, ccfg), runs=4)
        kept[mode] = int(select_tokens(scores, labels, layer,
                                       ccfg).kept_mask.sum())
    log(f"select_tokens, one layer, B=1, S={s}: topk_prefix host ms "
        f"{_spread(times['topk_prefix'])}; exact_greedy host ms "
        f"{_spread(times['exact_greedy'])}; kept {kept}")


def phase_sampled(label: str, device, mcfg, main_run,
                  repeats: int = 2) -> dict:
    """The sampled decode on the main run's prefill (its params, prompt and
    compression): SAMPLING for NEW_TOKENS - 1 steps through K2, counted
    (launches held exactly; the returned counts a bincount of the first and
    emitted tokens; every logprob finite and <= 0); top_k 1 at the same
    temperature, no penalty, against greedy (equal tokens up to an exact
    tie of two logits); greedy `decode_loop` against `decode_step` +
    argmax (equal tokens); then greedy and sampled
    decode timed `repeats` times each, in turns, and a profile of 10
    sampled steps. Returns the sampled run's launches."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.sampling import (
        SamplingParams)

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    layers, n = mcfg.num_layers, NEW_TOKENS - 1
    sampling = SamplingParams(**SAMPLING)
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    prefill = lambda: llama.prefill_compressed(  # noqa: E731
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)

    def sampled(logits, state, sp=sampling, **kw):
        return llama.decode_loop(params, torch.argmax(logits, -1), state, n,
                                 mcfg, ccfg, generator=gen, sampling=sp, **kw)

    out = {}

    def counted_decode(logits, state):
        out["first"] = torch.argmax(logits, -1)
        toks, state, out["counts"], out["lps"] = sampled(
            logits, state, return_counts=True, return_logprobs=True)
        return toks, state

    expect = {key: 0 for key in KERNELS}
    expect.update(K1=layers, K2=layers * n)
    toks, launches = _counted_run(f"{label} sampled", prefill,
                                  counted_decode, expect)[2:4]
    emitted = torch.cat([out["first"][:, None], toks], 1)
    bincount = torch.stack([torch.bincount(row, minlength=mcfg.vocab_size)
                            for row in emitted]).to(torch.int32)
    lps = out["lps"]
    log(f"{label} sampled {SAMPLING}: tokens {toks[0, :16].tolist()}...; "
        f"distinct {int(emitted.unique().numel())} of {n + 1}; logprobs "
        f"min {float(lps.min()):.3f} max {float(lps.max()):.3f}")
    check(torch.equal(out["counts"], bincount),
          f"{label}: counts equal a bincount of the first and emitted tokens")
    check(bool(torch.isfinite(lps).all()) and bool((lps <= 0).all()),
          f"{label}: logprobs finite and <= 0")

    # top_k 1 without penalties is greedy, except where two logits tie
    # exactly (bf16 logits; top-k keeps every tied maximum, as the
    # reference's does): up to the first differing step both runs saw the
    # same logits, so the two tokens there must have equal logprobs.
    logits, state, _ = prefill()
    greedy, _, lp_greedy = llama.decode_loop(
        params, torch.argmax(logits, -1), state, n, mcfg, ccfg,
        return_logprobs=True)
    logits, state, _ = prefill()
    top1, _, lp_top1 = sampled(
        logits, state, SamplingParams(temperature=SAMPLING["temperature"],
                                      top_k=1), return_logprobs=True)
    differ = (top1 != greedy)[0].nonzero()
    first = int(differ[0]) if len(differ) else None
    tie = first is not None and bool(lp_top1[0, first] == lp_greedy[0, first])
    log(f"{label}: top_k 1 at temperature {SAMPLING['temperature']} vs "
        f"greedy, tokens equal {first is None}"
        + ("" if first is None else f"; first differing step {first}, "
           f"logprobs {float(lp_top1[0, first])} / "
           f"{float(lp_greedy[0, first])} (an exact tie: {tie})"))
    check(first is None or tie, f"{label}: top_k 1 gives greedy tokens up "
                                f"to an exact tie")
    # Greedy `decode_loop` against the loop it was before sampling came:
    # `decode_step`, then argmax, n times.
    logits, state, _ = prefill()
    tok, manual = torch.argmax(logits, -1), []
    for _ in range(n):
        step_logits, state = llama.decode_step(params, tok, state, mcfg, ccfg)
        tok = torch.argmax(step_logits, -1)
        manual.append(tok)
    check(torch.equal(torch.stack(manual, 1), greedy),
          f"{label}: greedy decode_loop equals decode_step + argmax")

    rates = {"greedy": [], "sampled": []}
    for i in range(repeats):
        order = ("greedy", "sampled") if i % 2 == 0 else ("sampled",
                                                          "greedy")
        for arm in order:
            logits, state, _ = prefill()
            if arm == "greedy":
                fn = lambda: llama.decode_loop(  # noqa: E731
                    params, torch.argmax(logits, -1), state, n, mcfg, ccfg)
            else:
                fn = lambda: sampled(logits, state)  # noqa: E731
            _, ms = cuda_ms(fn)
            rates[arm].append(n / (ms / 1e3))
    log(f"{label} decode tok/s, {repeats} timed runs each, in turns: greedy "
        f"{_spread(rates['greedy'])}; sampled {_spread(rates['sampled'])}")
    logits, state, _ = prefill()
    _profile_window(label, "sampled decode 10 steps",
                    lambda: llama.decode_loop(
                        params, torch.argmax(logits, -1), state, 10, mcfg,
                        ccfg, generator=gen, sampling=sampling))
    return launches


def run_all(device, tiny, big, gemma, gemma7) -> list:
    """Every phase, in order; returns the kernels' entries for the JSON
    line. `tiny`, `big`, `gemma` and `gemma7` are the TinyLlama,
    Llama-2-7B, Gemma-2B and Gemma-7B configs (Gemma-7B for its heads
    only: 16 over 16 at head_dim 256)."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    two = lambda cfg: dataclasses.replace(cfg, num_layers=2)  # noqa: E731
    heads = lambda cfg: (cfg.num_heads, cfg.num_kv_heads,  # noqa: E731
                         cfg.head_dim)
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        log(f"elapsed {time.perf_counter() - t0:.1f} s: {what} done")

    phase_build()
    k1_tiny = phase_k1(device, (1, PROMPT, tiny.num_heads, tiny.num_kv_heads,
                                tiny.head_dim))
    k1 = phase_k1(device, (1, PROMPT, big.num_heads, big.num_kv_heads,
                           big.head_dim))
    k1b_tiny = phase_k1_chunk(device, (tiny.num_heads, tiny.num_kv_heads,
                                       tiny.head_dim))
    k1b_big = phase_k1_chunk(device, (big.num_heads, big.num_kv_heads,
                                      big.head_dim))
    k1_prefix_tiny = phase_k1_prefix(device, tiny)
    k1_prefix_big = phase_k1_prefix(device, big)
    k1c_tiny = phase_k1_full_pair(device, (tiny.num_heads, tiny.num_kv_heads,
                                           tiny.head_dim))
    k1c_big = phase_k1_full_pair(device, (big.num_heads, big.num_kv_heads,
                                          big.head_dim))
    k1_activations = phase_k1_activations(device, two(tiny))
    k2_tiny = phase_k2(device, two(tiny))
    k2 = phase_k2(device, two(big))
    k2p_tiny = phase_k2_pool(device, two(tiny), groups=(1, 2))
    k2p_big = phase_k2_pool(device, two(big), groups=(1, 4))
    # head_dim 256: every K1 mode and K2 form at Gemma-2B's and Gemma-7B's
    # heads.
    g = {}
    for name, cfg in (("gemma_2b", gemma), ("gemma_7b", gemma7)):
        g[name] = {
            "K1": phase_k1(device, (1, PROMPT) + heads(cfg)),
            "K1b": phase_k1_chunk(device, heads(cfg)),
            "K1prefix": phase_k1_prefix(device, cfg),
            "K1c": phase_k1_full_pair(device, heads(cfg)),
            "K2": phase_k2(device, two(cfg)),
            "K2pool": phase_k2_pool(device, two(cfg), groups=(1, 4))}
    mark("K1 and K2 phases")
    k3 = phase_k3(device, big.num_layers)
    k4 = phase_k4(device, big.num_layers)
    mark("K3 and K4 phases")
    phase_parity(device, two(tiny))
    phase_parity(device, two(gemma))
    for arm in ("int4", "w8a8"):
        phase_parity(device, two(big), arm, prompt=512, new_tokens=8)
    phase_parity_chunked(device, two(tiny))
    phase_parity_prefix(device, two(tiny))
    phase_parity_query(device, two(tiny))
    phase_exact_greedy(device)
    mark("float32 parity phases")
    n_steps = NEW_TOKENS - 1
    tiny_run = phase_main(
        "tinyllama main run", device, tiny,
        llama.fuse_params(llama.init_params(SEED, tiny, device)),
        {**{key: 0 for key in KERNELS}, "K1": tiny.num_layers,
         "K2": tiny.num_layers * n_steps})
    phase_profile("tinyllama", tiny, tiny_run)
    launches = {"tinyllama": tiny_run["launches"],
                "tinyllama_sampled": phase_sampled("tinyllama", device, tiny,
                                                   tiny_run)}
    del tiny_run
    torch.cuda.empty_cache()
    mark("tinyllama main and sampled runs")
    launches["tinyllama_chunked"] = phase_chunked_path(
        device, dataclasses.replace(tiny,
                                    max_position_embeddings=PROMPT + 512),
        repeats=2)
    mark("tinyllama chunked pooled run")
    launches["tinyllama_prefix"] = phase_prefix_path(
        device, dataclasses.replace(tiny,
                                    max_position_embeddings=PROMPT + 512))
    mark("tinyllama compressed-prefix run")
    launches.update(phase_query_path(device, tiny))
    mark("tinyllama query-guided runs")
    launches["gemma_2b"] = run_gemma(device, gemma)
    mark("gemma-2b run")
    routes = {}
    for arm in ("int4", "w8a8"):
        launches[f"llama2_7b_{arm}"], routes[arm] = run_7b_arm(arm, device,
                                                               big)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    def entry(key, result, path, extra=None):
        _, name, source, replaces = KERNELS[key]
        fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[path][key],
                **{f: result[f] for f in fields},
                "launches_by_path": {p: c[key] for p, c in launches.items()},
                **(extra or {})}

    shape_note = ("ms, plain_ms, bound_ms, library_ms: one decode step's "
                  f"calls ({big.num_layers} layers x 4 matmuls{{}}) at M=1, "
                  "bf16")
    chunk_note = (f"B=2 c={CHUNK} over S_k={PROMPT}, Hq={{}} Hkv={{}} "
                  f"d={{}}, bf16; ms, plain_ms, bound_ms, library_ms: the "
                  f"{PROMPT // CHUNK} chunk offsets summed, one layer's "
                  f"chunked prefill")
    pool_note = (f"layer 0 of a 2-layer {{}} state, B={len(LENGTHS)} "
                 f"lengths {LENGTHS} right-padded to {PROMPT}, after 330 "
                 f"steps (ring {RING}, {POOL_BLOCKS} pool blocks, wrapped); "
                 f"{{}}")
    prefix_note = (f"B={PREFIX_BATCH} c={CHUNK} at q_offsets 0-"
                   f"{PROMPT - CHUNK}, Hq={{}} Hkv={{}} d={{}}, bf16, over "
                   f"layer 0's pools of a {PROMPT}-token compressed-prefix "
                   f"prefill; ms, plain_ms, bound_ms, library_ms: the "
                   f"{PROMPT // CHUNK} chunks summed, one layer's prefill")
    pair_note = (f"B={PREFIX_BATCH} S_q=S_k={CHUNK}, Hq={{}} Hkv={{}} d={{}}, "
                 f"bf16")
    k2_err = max(r["max_abs_err"] for r in (
        k2, k2_tiny, k2p_tiny, k2p_big,
        *(g[m][p] for m in g for p in ("K2", "K2pool"))))

    g_cfgs = {"gemma_2b": gemma, "gemma_7b": gemma7}

    def d256(part, note, pick=lambda r: r):
        """The d=256 readings of one kernel at Gemma-2B's and Gemma-7B's
        heads, with `note` formatted by the heads."""
        return {m: {**pick(g[m][part]),
                    "shape": note.format(*heads(g_cfgs[m]))} for m in g}

    def worst(*results):
        return max(r["max_abs_err"] for r in results)

    k1_note = f"B=1 S={PROMPT} Hq={{}} Hkv={{}} d={{}}"
    kernels = [
        entry("K1", {**k1, "max_abs_err": worst(
            k1, k1_tiny, *(g[m]["K1"] for m in g))}, "llama2_7b_int4", {
            "mode": "a (square causal)",
            "shape": "B=1 S=4096 Hq=Hkv=32 d=128 bf16",
            "library": "scaled_dot_product_attention, causal, no prompt "
                       "mass",
            "tinyllama": {**k1_tiny, "shape": "B=1 S=4096 Hq=32 Hkv=4 d=64"},
            **d256("K1", k1_note),
            "model_activations_max_abs_err": k1_activations}),
        entry("K1b", {**k1b_tiny, "max_abs_err": worst(
            k1b_tiny, k1b_big, *(g[m]["K1b"] for m in g))},
              "tinyllama_chunked", {
            "mode": "b (rectangular causal at q_offset, chunked prefill)",
            "shape": chunk_note.format(tiny.num_heads, tiny.num_kv_heads,
                                       tiny.head_dim),
            "library": "scaled_dot_product_attention with a boolean "
                       "[c, S_k] causal mask, no prompt mass",
            "llama2_7b": {**k1b_big, "shape": chunk_note.format(
                big.num_heads, big.num_kv_heads, big.head_dim)},
            **d256("K1b", chunk_note)}),
        entry("K1c", {**k1c_tiny, "max_abs_err": worst(
            k1c_tiny, k1c_big, *(g[m]["K1c"] for m in g))},
              "tinyllama_prefix", {
            "mode": "c (non-causal pair, ring attention's off-diagonal "
                    "block; on no path the port runs yet)",
            "shape": pair_note.format(tiny.num_heads, tiny.num_kv_heads,
                                      tiny.head_dim),
            "library": "scaled_dot_product_attention, no mask, no prompt "
                       "mass",
            "llama2_7b": {**k1c_big, "shape": pair_note.format(
                big.num_heads, big.num_kv_heads, big.head_dim)},
            **d256("K1c", pair_note)}),
        entry("K1d", {**k1_prefix_tiny["positioned"], "max_abs_err": worst(
            k1_prefix_tiny["positioned"], k1_prefix_big["positioned"],
            *(g[m]["K1prefix"]["positioned"] for m in g))},
              "tinyllama_prefix", {
            "mode": "d (positioned keys: compressed pools)",
            "shape": prefix_note.format(tiny.num_heads, tiny.num_kv_heads,
                                        tiny.head_dim),
            "library": "scaled_dot_product_attention with a boolean [c, N] "
                       "mask from the positions, no prompt mass",
            "llama2_7b": {**k1_prefix_big["positioned"],
                          "shape": prefix_note.format(
                              big.num_heads, big.num_kv_heads,
                              big.head_dim)},
            **d256("K1prefix", prefix_note, lambda r: r["positioned"])}),
        entry("K1p", {**k1_prefix_tiny["pair"], "max_abs_err": worst(
            k1_prefix_tiny["pair"], k1_prefix_big["pair"],
            *(g[m]["K1prefix"]["pair"] for m in g))}, "tinyllama_prefix", {
            "mode": "diagonal pair (mode a with lse, local prompt length)",
            "shape": prefix_note.format(tiny.num_heads, tiny.num_kv_heads,
                                        tiny.head_dim),
            "library": "scaled_dot_product_attention, causal, no prompt "
                       "mass",
            "llama2_7b": {**k1_prefix_big["pair"],
                          "shape": prefix_note.format(
                              big.num_heads, big.num_kv_heads,
                              big.head_dim)},
            **d256("K1prefix", prefix_note, lambda r: r["pair"])}),
        entry("K2", {**k2, "max_abs_err": k2_err}, "llama2_7b_int4", {
            "shape": "layer 0 of a 4096-token Llama-2-7B state, 8/4/2, "
                     "tiers + ring, bf16",
            "kernels_per_call": 1,
            "device_us_per_call": k2["device_us"],
            "tinyllama": k2_tiny,
            **{m: {**g[m]["K2"], "shape": f"layer 0 of a 4096-token {m} "
                                          f"state, 8/4/2, tiers + ring, bf16"}
               for m in g},
            "pool": {  # the decode-pool segment and G > 1 (chunked path)
                "tinyllama": {**k2p_tiny, "shape": pool_note.format(
                    "TinyLlama", k2p_tiny["variant"])},
                "llama2_7b": {**k2p_big, "shape": pool_note.format(
                    "Llama-2-7B", k2p_big["variant"])},
                **{m: {**g[m]["K2pool"], "shape": pool_note.format(
                    m, g[m]["K2pool"]["variant"])} for m in g}}}),
        entry("K3", k3, "llama2_7b_int4", {
            "shape": shape_note.format(""), "prefill": k3["prefill"],
            "launches_by_route": routes["int4"],
            "m1_device_us_per_launch": k3["m1_device_us"],
            "library": "torch._weight_int4pack_mm, same codes, bf16 "
                       "scales"}),
        entry("K4", k4, "llama2_7b_w8a8", {
            "shape": shape_note.format(" + lm_head") + (
                f"; prefill: {big.num_layers} layers x 4 matmuls at M="
                f"{PROMPT} + lm_head at M=1, its library_ms the "
                f"{big.num_layers} x 4 layer matmuls alone (beside "
                f"ms_layer_matmuls)"),
            "prefill": k4["prefill"],
            "prefill_library_ms_by_weight_layout":
                k4["prefill_library_by_layout"],
            "m1_device_us_per_launch": k4["m1_device_us"],
            "routes": k4["routes"],
            "launches_by_route": routes["w8a8"],
            "library": "torch._int_mm + scaling, the faster of the [K, N] "
                       "weights and a K-major copy (refuses M=1)"}),
    ]
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from realtime_kv_cache_compression_tpu_torch import (LLAMA2_7B,
                                                         TINYLLAMA_1_1B)
    from realtime_kv_cache_compression_tpu_torch.config import (GEMMA_2B,
                                                                GEMMA_7B)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    kernels = run_all(
        "cuda", dataclasses.replace(TINYLLAMA_1_1B,
                                    max_position_embeddings=PROMPT
                                    + NEW_TOKENS),
        dataclasses.replace(LLAMA2_7B,
                            max_position_embeddings=PROMPT + NEW_TOKENS),
        GEMMA_2B, GEMMA_7B)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
