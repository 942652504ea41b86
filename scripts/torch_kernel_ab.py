"""A/B timing of the PyTorch port's kernels across two trees.

    python3 scripts/torch_kernel_ab.py TREE_A TREE_B [TREE ...]

Each TREE is the root of a checkout that holds
`realtime_kv_cache_compression_tpu_torch/` (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and `.`). The
trees are measured in the order given, each in a fresh process that
imports the package from that tree and builds its kernels there, so list
them as A B B A to spread drift over both. Needs one CUDA device.

Per tree:
- K2 over tiers + ring on layer 0 of 2-layer 4096-token states at
  TinyLlama's, Llama-2-7B's and Gemma-2B's (head_dim 256) widths, bf16,
  8/4/2 tiers after 5 decode steps: ms per wrapper call (CUDA events over
  back-to-back calls), device us per call (every kernel of the call, by
  torch.profiler) and kernels per call;
- K2 with the decode pool and G > 1 scale groups (4-bit pool of 4 blocks
  over a 64-token ring, B=2 with lengths 4096 and 3000, after 200 steps)
  at TinyLlama's (G=2) and Llama-2-7B's (G=4) widths: device us per call;
- K1 mode (a), B=1 S=4096, bf16, at both widths: ms per call;
- K1's other modes at chip_smoke.py's shapes, bf16, at both widths: mode
  (b), B=2, chunks of 1024 over a 4096-key buffer at offsets 0-3072 (ms
  summed over the four); mode (d), the same chunks over 4096 pool slots
  that hold 820 valid keys per earlier chunk (layer 0's pools, ratio 0.8)
  at positions drawn from SEED, the rest invalid (summed); the diagonal
  pair over each chunk's own keys (summed); mode (c), B=2, S_q = S_k =
  1024;
- K3 at the four fused Llama-2-7B matmul shapes (int4, groups of 128,
  bf16 x): one decode step's 128 calls at M=1 (ms, CUDA events) and the
  mean device us per call of the int4 kernels (torch.profiler), and one
  prefill's 128 calls at M=4096 (ms);
- K4 (W8A8) at the same shapes, bf16 output: the mean device us per call
  of the int8 kernels at M=1 (every kernel of the call) and one prefill's
  128 calls at M=4096 (ms);
- TinyLlama at full depth, prompt 4096, 127 decode steps: TTFT and decode
  tok/s, medians of 3 timed runs after a warm-up.
Prints one JSON line per tree and a table at the end.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
PROMPT = 4096
NEW_TOKENS = 128
CHUNK = 1024


def _own_timing():
    """This checkout's `utils/timing.py`, loaded by path under its own name:
    the trees measured may predate it, and each imports the package from
    itself."""
    path = (Path(__file__).resolve().parents[1]
            / "realtime_kv_cache_compression_tpu_torch" / "utils" / "timing.py")
    spec = importlib.util.spec_from_file_location("ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from realtime_kv_cache_compression_tpu_torch import (
        LLAMA2_7B, TINYLLAMA_1_1B, CompressionConfig)
    from realtime_kv_cache_compression_tpu_torch.config import GEMMA_2B
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import _build
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import fused_decode_attention
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import (POS_SENTINEL, flash_chunk_attention_with_prompt_mass,
                flash_diagonal_pair_attention, flash_full_pair_attention,
                flash_positioned_attention, flash_prefill_with_prompt_mass)

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}

    timing = _own_timing()

    def cuda_ms(fn, reps):
        fn()  # warm-up
        return timing.cuda_ms(fn, reps)[1]

    dev = "cuda"

    def k1_modes(mcfg, plen, gen, b=2, c=CHUNK):
        """ms of K1 modes (b), (d), the diagonal pair (each summed over the
        PROMPT // c chunks) and (c), bf16, at mcfg's heads."""
        hq, hkv, d = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
        bf = torch.bfloat16

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(bf)

        k_buf, v_buf = rnd(b, PROMPT, hkv, d), rnd(b, PROMPT, hkv, d)
        plens = torch.tensor([plen, plen * 3 // 4], device=dev)
        res = {"k1b": 0.0, "k1d": 0.0, "k1p": 0.0}
        for off in range(0, PROMPT, c):
            q, k_c, v_c = rnd(b, c, hq, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d)
            kept = off // c * (c * 4 // 5)  # 820 of 1024 per earlier chunk
            pos = torch.full((b, PROMPT), POS_SENTINEL, dtype=torch.int32,
                             device=dev)
            for r in range(b):
                pos[r, :kept] = torch.sort(torch.randperm(
                    max(off, 1), generator=gen, device=dev)[:kept])[0]
            res["k1b"] += cuda_ms(
                lambda: flash_chunk_attention_with_prompt_mass(  # noqa
                    q, k_buf, v_buf, off, plen, prompt_lens=plens), 10)
            res["k1d"] += cuda_ms(lambda: flash_positioned_attention(  # noqa
                q, k_buf, v_buf, pos, off, plen), 10)
            local = min(max(plen - off, 0), c)
            res["k1p"] += cuda_ms(
                lambda: flash_diagonal_pair_attention(  # noqa: E731
                    q, k_c, v_c, local), 10)
        q, k, v = rnd(b, c, hq, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d)
        plen_c = torch.tensor([c // 4, 0], dtype=torch.int32, device=dev)
        res["k1c"] = cuda_ms(
            lambda: flash_full_pair_attention(q, k, v, plen_c), 10)
        return res

    # K3: per forward of Llama-2-7B, 32 layers x the four fused matmuls.
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_tensor_int4
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int4_matmul \
        import int4_matmul_tensor
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    step_ms = prefill_ms = 0.0
    device_us = []
    for k, n in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)):
        w = quantize_tensor_int4(torch.randn((k, n), generator=gen,
                                             device=dev) * k ** -0.5,
                                 group_size=128)
        x1, xp = (torch.randn((m, k), generator=gen, device=dev)
                  .to(torch.bfloat16) for m in (1, PROMPT))
        step_ms += 32 * cuda_ms(lambda: int4_matmul_tensor(x1, w), 50)
        prefill_ms += 32 * cuda_ms(lambda: int4_matmul_tensor(xp, w), 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                int4_matmul_tensor(x1, w)
            torch.cuda.synchronize()
        device_us.append(sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == DeviceType.CUDA
                             and "int4" in e.name) / 20)
        del w, x1, xp
    out["k3_decode_step_ms"] = step_ms
    out["k3_m1_device_us"] = sum(device_us) / len(device_us)
    out["k3_prefill_ms"] = prefill_ms
    torch.cuda.empty_cache()

    def device_us_per_call(call, calls=100):
        """(device us per call, kernels per call) of `call`."""
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return (sum(e.time_range.elapsed_us() for e in ev) / calls,
                len(ev) / calls)

    # K4: per forward of Llama-2-7B W8A8, 32 layers x the four matmuls.
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int8_matmul \
        import int8_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    prefill_ms, device_us = 0.0, []
    for k, n in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)):
        w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        ws = torch.rand((n,), generator=gen, device=dev) / 127 + 1e-4
        x1, xp = (torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                                dtype=torch.int8) for m in (1, PROMPT))
        s1, sp = (torch.rand((m,), generator=gen, device=dev) / 127 + 1e-4
                  for m in (1, PROMPT))
        prefill_ms += 32 * cuda_ms(lambda: int8_matmul(xp, w_q, sp, ws), 3)
        device_us.append(device_us_per_call(lambda: int8_matmul(x1, w_q, s1, ws),
                                   20)[0])
        del w_q, x1, xp
    out["k4_m1_device_us"] = sum(device_us) / len(device_us)
    out["k4_prefill_ms"] = prefill_ms
    torch.cuda.empty_cache()

    width = {"tinyllama": TINYLLAMA_1_1B, "llama2_7b": LLAMA2_7B,
             "gemma_2b": GEMMA_2B}
    for name, base in width.items():
        mcfg = dataclasses.replace(base, num_layers=2,
                                   max_position_embeddings=PROMPT
                                   + NEW_TOKENS)
        ccfg = CompressionConfig(num_layers=2)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        ids = torch.randint(0, mcfg.vocab_size, (1, PROMPT), generator=gen,
                            device=dev)
        params = llama.fuse_params(llama.init_params(SEED, mcfg, dev))
        logits, state, _ = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)
        _, state = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                     5, mcfg, ccfg)
        q = torch.randn((1, 1, mcfg.num_heads, mcfg.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        q_pos = state.position[:, None]
        cache, recent = state.caches[0], state.recents[0]
        k2 = lambda: fused_decode_attention(  # noqa: E731
            q, cache, recent, q_pos, ccfg)
        out[f"k2_{name}_ms"] = [cuda_ms(k2, 200) for _ in range(3)]
        (out[f"k2_{name}_device_us"],
         out[f"k2_{name}_kernels"]) = device_us_per_call(k2)
        del state, cache, recent
        if name != "gemma_2b":
            # The decode pool and G > 1 groups at the chunked path's batch.
            groups = 2 if name == "tinyllama" else 4
            pccfg = CompressionConfig(
                num_layers=2, quant_group_size=mcfg.head_dim // groups,
                decode_pool_blocks=4, decode_pool_bits=4)
            lengths = torch.tensor([PROMPT, 3000], device=dev)
            ids2 = torch.randint(0, mcfg.vocab_size, (2, PROMPT),
                                 generator=gen, device=dev)
            logits, state, _ = llama.prefill_compressed(
                params, ids2, mcfg, pccfg, max_decode_len=64,
                lengths=lengths)
            _, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                         state, 200, mcfg, pccfg)
            q2 = torch.randn((2, 1, mcfg.num_heads, mcfg.head_dim),
                             generator=gen, device=dev).to(torch.bfloat16)
            q2_pos = state.position[:, None]
            c2, r2, p2 = state.caches[0], state.recents[0], state.pools[0]
            out[f"k2_pool_{name}_device_us"] = device_us_per_call(
                lambda: fused_decode_attention(  # noqa: E731
                    q2, c2, r2, q2_pos, pccfg, pool=p2))[0]
            del state, c2, r2, p2
        if name == "gemma_2b":
            del params
            torch.cuda.empty_cache()
            continue
        qkv = torch.randn((1, PROMPT, (mcfg.num_heads + 2
                                       * mcfg.num_kv_heads) * mcfg.head_dim),
                          generator=gen, device=dev).to(torch.bfloat16)
        qq, kk, vv = (t.unflatten(-1, (-1, mcfg.head_dim)) for t in qkv.split(
            [mcfg.num_heads * mcfg.head_dim,
             mcfg.num_kv_heads * mcfg.head_dim,
             mcfg.num_kv_heads * mcfg.head_dim], dim=-1))
        plen = ccfg.prompt_length(PROMPT)
        out[f"k1_{name}_ms"] = cuda_ms(
            lambda: flash_prefill_with_prompt_mass(qq, kk, vv, plen), 10)
        out.update({f"{key}_{name}_ms": ms for key, ms in
                    k1_modes(mcfg, plen, gen).items()})
        del params, qkv
        torch.cuda.empty_cache()

    mcfg = dataclasses.replace(TINYLLAMA_1_1B,
                               max_position_embeddings=PROMPT + NEW_TOKENS)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    ids = torch.randint(0, mcfg.vocab_size, (1, PROMPT), generator=gen,
                        device=dev)
    ttft, rate = [], []
    for i in range(4):  # the first is the warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, state, _ = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        llama.decode_loop(params, torch.argmax(logits, -1), state,
                          NEW_TOKENS - 1, mcfg, ccfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i:
            ttft.append((t1 - t) * 1e3)
            rate.append((NEW_TOKENS - 1) / (t2 - t1))
    out["tinyllama_ttft_ms"] = ttft
    out["tinyllama_decode_tok_s"] = rate
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
                             capture_output=True, text=True, timeout=1200)
        sys.stderr.write(res.stderr[-4000:])
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode or not line:
            print(f"{tree}: failed (rc {res.returncode})", flush=True)
            return 1
        rows.append(json.loads(line[-1][3:]))
        print(line[-1][3:], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    keys = (*(f"k2_{w}_{m}" for w in ("tinyllama", "llama2_7b", "gemma_2b")
              for m in ("ms", "device_us", "kernels")),
            "k2_pool_tinyllama_device_us", "k2_pool_llama2_7b_device_us",
            "k1_tinyllama_ms", "k1_llama2_7b_ms",
            *(f"{m}_{w}_ms" for m in ("k1b", "k1d", "k1p", "k1c")
              for w in ("tinyllama", "llama2_7b")),
            "k3_decode_step_ms", "k3_m1_device_us", "k3_prefill_ms",
            "k4_m1_device_us", "k4_prefill_ms",
            "tinyllama_ttft_ms", "tinyllama_decode_tok_s")
    median = _own_timing().median
    for i, r in enumerate(rows):
        cells = []
        for k in keys:
            v = r[k]
            v = median(v) if isinstance(v, list) else v
            cells.append(f"{k} {v:.4f}")
        print(f"run {i + 1} {r['tree']}: " + "; ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
