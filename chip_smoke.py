"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `realtime_kv_cache_compression_tpu_torch/
csrc`, checks each kernel against its plain PyTorch version at the main
path's shapes in bf16 and float32, checks the kernel path against the plain
path end to end in float32 (equal greedy tokens), then runs the main path
at full width: TinyLlama-1.1B shape (22 layers, bf16, fused weights, random
weights from a seed), prompt 4096, batch 1, 128 new tokens, tiers 8/4/2
bits, compressed prefill with K1 and fused decode with K2, once counted and
REPEATS times timed (median and spread), plus the uncompressed arm, and
last a torch.profiler breakdown of the main run (device idle share, top
kernels). Any failed check exits nonzero. The last line is the device
JSON.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.metadata
import json
import subprocess
import sys
import time

import torch

K1_SOURCE = "realtime_kv_cache_compression_tpu_torch/csrc/flash_prefill.cu"
K1_REPLACES = "realtime_kv_cache_compression_tpu/ops/pallas/flash_prefill.py:39"
K2_SOURCE = "realtime_kv_cache_compression_tpu_torch/csrc/decode_attention.cu"
K2_REPLACES = ("realtime_kv_cache_compression_tpu/ops/pallas/"
               "decode_attention.py:143")

# Tolerances. float32 kernel vs float32 reference: summation order and
# exp2-vs-exp rounding; K1 within 1e-4, K2 within 1e-5, prompt mass within
# 1e-5. bf16 outputs: both sides compute in float32 and round to bf16 once,
# so an element may differ by one bf16 ulp of its own magnitude; the limit
# is two ulps of |reference| per element, plus a floor for float32
# rounding in elements near zero.
TOL_K1_F32 = 1e-4
TOL_K2_F32 = 1e-5
TOL_MASS = 1e-5
BF16_ULPS = 2
BF16_FLOOR = 1e-5

SEED = 0
PROMPT = 4096
NEW_TOKENS = 128
REPEATS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_share(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest share of its limit that any element's error uses; the limit
    is BF16_ULPS bf16 ulps of |ref| plus BF16_FLOOR. Passes at <= 1."""
    ref = ref.float()
    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8-bit significand
    err = (out.float() - ref).abs()
    return float((err / (BF16_ULPS * ulp + BF16_FLOOR)).max())


def check_close(out, ref, tol, what: str) -> float:
    """Checks `out` against `ref` (bf16: the per-element ulp limit; float32:
    `tol` absolute), logs the result and returns the max abs error."""
    err = max_err(out, ref)
    peak = float(ref.float().abs().max())
    if out.dtype == torch.bfloat16:
        share = bf16_share(out, ref)
        log(f"{what}: max abs err {err:.3e}, max|ref| {peak:.3e}, worst "
            f"element at {share:.3f} of its limit ({BF16_ULPS} bf16 ulps "
            f"+ {BF16_FLOOR})")
        check(share <= 1.0, what)
    else:
        log(f"{what}: max abs err {err:.3e} (tol {tol}), max|ref| "
            f"{peak:.3e}")
        check(err <= tol, what)
    return err


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


def phase_build() -> None:
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    kl = _build.load_library()
    log(f"build: {kl.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kl.build_seconds:.1f} s)")
    for line in kl.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


def _fused_qkv(gen, b, s, hq, hkv, d, dtype, device):
    """q, k, v as column slices of one fused projection [B, S, (Hq + 2 Hkv)
    D], strided as the main path's fused QKV hands them to K1."""
    qkv = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen,
                      device=device).to(dtype)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return (q.unflatten(-1, (hq, d)), k.unflatten(-1, (hkv, d)),
            v.unflatten(-1, (hkv, d)))


def phase_k1(device, shape=(1, PROMPT, 32, 4, 64), ragged=(2, 1000),
             reps: int = 10) -> dict:
    """K1 against its plain version on strided q/k/v: the main-path shape
    in bf16 (timed) and float32, then a ragged S with per-row prompt
    lengths in both dtypes."""
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
        o_ref, pm_ref = prefill_attention_with_prompt_mass(
            q, k, v, plen, prompt_lens=lens)
        what = (f"K1 {tuple(q.shape)} {str(dtype)[6:]} plens "
                f"{plen if lens is None else lens.tolist()}")
        worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what + " out"),
                    check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
        del o_ref, pm_ref
        if timing is None:  # the main path's shape and dtype
            timing = kernel_and_plain_ms(
                lambda: flash_prefill_with_prompt_mass(q, k, v, plen),
                lambda: prefill_attention_with_prompt_mass(q, k, v, plen),
                reps)
            log(f"K1 main shape: kernel {timing[0]:.4f} ms, plain "
                f"{timing[1]:.4f} ms")
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def phase_k2(device, mcfg, prompt: int = PROMPT, decode_steps: int = 5,
             reps: int = 20) -> dict:
    """K2 against dequantize + attention_over_tokens on real decode states:
    a full-width prefill at reduced depth, a few decode steps into the
    ring, then every layer's cache at 8/4/2 and at the anchor config's
    16/8/4 tiers, in bf16 (8/4/2 layer 0 timed) and in float32."""
    from realtime_kv_cache_compression_tpu_torch import (
        CompressionConfig, reference_anchor_config)
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
            if timing is None:  # the main path's dtype and tiers
                cache, recent = state.caches[0], state.recents[0]
                timing = kernel_and_plain_ms(
                    lambda: fused_decode_attention(q, cache, recent, q_pos,
                                                   ccfg),
                    lambda: decode_attention_plain(q, cache, recent, q_pos,
                                                   ccfg), reps)
                log(f"K2 {name} {dtype} layer 0: kernel {timing[0]:.4f} ms,"
                    f" plain {timing[1]:.4f} ms")
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def phase_parity(device, mcfg, prompt: int = 1024, new_tokens: int = 16):
    """Kernel path vs plain path in float32: equal greedy tokens."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    runs = {}
    for kernels in (True, False):
        logits, state, _ = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=new_tokens,
            use_flash=kernels)
        tok = torch.argmax(logits, -1)
        toks, _ = llama.decode_loop(params, tok, state, new_tokens - 1, mcfg,
                                    ccfg, use_fused=kernels)
        runs[kernels] = (torch.cat([tok[:, None], toks], 1), state, logits)
    (tk, sk, lk), (tp, sp, lp) = runs[True], runs[False]
    for i, (ck, cp) in enumerate(zip(sk.caches, sp.caches)):
        agree = [float((a.positions == b.positions).float().mean())
                 if a.capacity else 1.0 for a, b in zip(ck.tiers, cp.tiers)]
        log(f"parity layer {i}: kept-position agreement per tier "
            f"(high, mid, low) {agree}")
    log(f"parity f32: prefill logits max err {max_err(lk, lp):.3e}; "
        f"tokens kernel {tk.tolist()} plain {tp.tolist()}")
    check(torch.equal(tk, tp), "greedy tokens of kernel and plain paths")


def _spread(xs) -> str:
    xs = sorted(xs)
    return (f"median {xs[len(xs) // 2]:.3f} (min {xs[0]:.3f}, max "
            f"{xs[-1]:.3f}; runs {', '.join(f'{x:.3f}' for x in xs)})")


def phase_main(device, mcfg, prompt: int = PROMPT,
               new_tokens: int = NEW_TOKENS,
               repeats: int = REPEATS) -> dict:
    """The main path at full width, counted once (the warm-up), then timed
    `repeats` times; then the uncompressed arm, timed the same way."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import fused_decode_attention
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_prefill_with_prompt_mass

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)  # tiers 8/4/2
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    n_steps = new_tokens - 1
    prefill = lambda: llama.prefill_compressed(params, ids, mcfg, ccfg,
                                               max_decode_len=new_tokens)

    torch.cuda.reset_peak_memory_stats()
    flash_prefill_with_prompt_mass.launches = 0
    fused_decode_attention.launches = 0
    logits, state, stats = prefill()
    toks, state = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    n_steps, mcfg, ccfg)
    torch.cuda.synchronize()
    k1, k2 = (flash_prefill_with_prompt_mass.launches,
              fused_decode_attention.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    summary = summarize_layer_stats(stats)
    log(f"main run launches: K1 {k1} (expect {mcfg.num_layers}), K2 {k2} "
        f"(expect {mcfg.num_layers * n_steps})")
    check(k1 == mcfg.num_layers and k2 == mcfg.num_layers * n_steps,
          "main path launched K1 once per layer and K2 once per layer-step")
    check(toks.shape == (1, n_steps) and bool(torch.isfinite(logits).all()),
          "main run output shape and finite logits")
    check(0.0 < summary["avg_compression_ratio"] < 1.0,
          "kept ratio in (0, 1)")
    log(f"main run: kept_ratio {summary['avg_compression_ratio']:.4f}, "
        f"byte_savings {summary['avg_memory_savings']:.4f}, peak memory "
        f"{peak_mb:.1f} MB")

    ttft, rate = [], []
    for _ in range(repeats):
        (logits, state, _), ms = cuda_ms(prefill)
        tok = torch.argmax(logits, -1)
        _, dec_ms = cuda_ms(lambda: llama.decode_loop(
            params, tok, state, n_steps, mcfg, ccfg))
        ttft.append(ms)
        rate.append(n_steps / (dec_ms / 1e3))
    log(f"main run (compressed), {repeats} timed runs: TTFT ms "
        f"{_spread(ttft)}; decode tok/s {_spread(rate)}")

    # Uncompressed arm (its prefill runs K1 as well).
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, new_tokens))
    pos = torch.full((1,), prompt, dtype=torch.int32, device=device)
    ttft_u, rate_u = [], []
    for i in range(repeats + 1):  # the first is the warm-up
        (lo, (ks, vs)), ms = cuda_ms(
            lambda: llama.prefill_uncompressed(params, ids, mcfg))
        tok, kv = torch.argmax(lo, -1), (pad(ks), pad(vs))
        _, dec_ms = cuda_ms(lambda: llama.decode_loop_uncompressed(
            params, tok, kv, pos, n_steps, mcfg))
        if i:
            ttft_u.append(ms)
            rate_u.append(n_steps / (dec_ms / 1e3))
    log(f"main run (uncompressed arm), {repeats} timed runs: TTFT ms "
        f"{_spread(ttft_u)}; decode tok/s {_spread(rate_u)}")
    return {"k1_launches": k1, "k2_launches": k2, "params": params,
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


def phase_profile(mcfg, main_run, decode_steps: int = 10,
                  top: int = 6) -> None:
    """Where the time goes in the main run: torch.profiler over one
    compressed prefill and over `decode_steps` decode steps; device busy
    time against host wall time (the profiler slows the host), and the
    kernels that take most device time. Then `compress_layer_kv` of one
    layer alone, on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from realtime_kv_cache_compression_tpu_torch.compression import (
        compress_layer_kv)
    from realtime_kv_cache_compression_tpu_torch.models import llama

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    logits, state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)
    tok = torch.argmax(logits, -1)
    for what, fn in (
            ("prefill", lambda: llama.prefill_compressed(
                params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)),
            (f"decode {decode_steps} steps", lambda: llama.decode_loop(
                params, tok, state, decode_steps, mcfg, ccfg))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = _device_busy_ms(prof)
        log(f"profile {what}: wall {wall:.3f} ms, device busy {busy:.3f} "
            f"ms, device idle share {1 - busy / wall:.4f}")
        check(busy > 0, f"profile {what} saw device time")
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, t = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (n + 1, t + e.time_range.elapsed_us())
        for name, (n, t) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][1])[:top]:
            log(f"  {t / 1e3:9.3f} ms  {n:5d} x  {name[:90]}")

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
    log(f"compress_layer_kv alone, one layer, S={s}: host ms "
        f"{_spread(times[1:])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from realtime_kv_cache_compression_tpu_torch import TINYLLAMA_1_1B

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    mcfg = dataclasses.replace(TINYLLAMA_1_1B,
                               max_position_embeddings=PROMPT + NEW_TOKENS)
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    k1 = phase_k1(device)
    k2 = phase_k2(device, dataclasses.replace(mcfg, num_layers=2))
    phase_parity(device, dataclasses.replace(mcfg, num_layers=2))
    main_run = phase_main(device, mcfg)
    phase_profile(mcfg, main_run)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = [
        {"name": "flash_prefill_with_prompt_mass", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": main_run["k1_launches"], **k1},
        {"name": "fused_decode_attention", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": main_run["k2_launches"], **k2},
    ]
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
