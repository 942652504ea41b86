"""Performance benchmark suite: named scenarios × sequence lengths.

Port of the JAX package's `eval/benchmark_runner.py`: six named config
scenarios, synthetic test sequences at target token lengths, per-config
TTFT / tokens-per-second / memory measurement, mean/std/min/max/median
aggregation, matplotlib plots (skipped when matplotlib is missing) and a
markdown summary report.

Timing is the JAX package's: best of 3 walls that end in a host read, less
the measured round trip (utils/timing.py), after a warm-up call of the
prefill and of the decode loop. Decode updates the recent rings in place,
so each timed decode loop runs on its own copy of the prefill's state
(`llama.clone_decode_state`, made outside the timed region). Params come
from the port's `init_params(0, ...)` on `device` and the synthetic ids
from a `torch.Generator` (other numbers than the JAX package's
`jax.random`). Memory is the device's allocator statistics
(utils/memory.py) and the compression stats' physical byte savings. With
`use_flash=None` the compressed scenarios run K1 and K2 on a CUDA device,
the baseline K1 in its prefill.
"""

from __future__ import annotations

import os
import statistics
from typing import Any, Dict, Optional, Sequence

import torch

from ..compression.compressor import summarize_layer_stats
from ..config import CompressionConfig, ModelConfig
from ..models import llama
from ..utils.data import save_json
from ..utils.memory import device_memory_stats
from ..utils.timing import measure_rtt, readback, timed


def named_scenarios(num_layers: int) -> Dict[str, Optional[CompressionConfig]]:
    """Six scenarios mirroring `benchmark runner.py`:41-82: an uncompressed
    baseline plus conservative/balanced/aggressive compression strengths and
    the two importance-weighting emphases."""
    mk = lambda **kw: CompressionConfig(num_layers=num_layers, **kw)  # noqa: E731
    return {
        "baseline": None,
        "conservative": mk(early_layer_ratio=0.9, middle_layer_ratio=0.8,
                           later_layer_ratio=0.7, high_precision_bits=16,
                           medium_precision_bits=8, low_precision_bits=4,
                           theta_h=0.5, theta_m=0.2),
        "balanced": mk(high_precision_bits=8, medium_precision_bits=4,
                       low_precision_bits=2),
        "aggressive": mk(early_layer_ratio=0.6, middle_layer_ratio=0.4,
                         later_layer_ratio=0.25, high_precision_bits=8,
                         medium_precision_bits=4, low_precision_bits=2,
                         theta_h=0.8, theta_m=0.5),
        "prompt_focused": mk(alpha=0.7, beta=0.15, gamma=0.15,
                             high_precision_bits=8, medium_precision_bits=4,
                             low_precision_bits=2),
        "position_focused": mk(alpha=0.15, beta=0.7, gamma=0.15,
                               high_precision_bits=8, medium_precision_bits=4,
                               low_precision_bits=2),
    }


class CompressionBenchmark:
    def __init__(self, mcfg: ModelConfig, params=None,
                 output_dir: Optional[str] = None,
                 seq_lens: Sequence[int] = (1024, 2048, 4096),
                 new_tokens: int = 50, batch: int = 1,
                 use_flash: Optional[bool] = None, device="cuda"):
        self.mcfg = mcfg
        self.device = torch.device(device)
        self.params = params if params is not None else llama.init_params(
            0, mcfg, device=self.device)
        self.output_dir = output_dir
        self.seq_lens = list(seq_lens)
        self.new_tokens = new_tokens
        self.batch = batch
        self.use_flash = use_flash
        self.rtt = measure_rtt(device=self.device)
        self.results: Dict[str, Any] = {}

    # -- measurement --------------------------------------------------------

    def _synthetic_ids(self, seq_len: int, seed: int = 0) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randint(0, self.mcfg.vocab_size, (self.batch, seq_len),
                             generator=gen, device=self.device)

    def measure_single_inference(self, ccfg: Optional[CompressionConfig],
                                 seq_len: int) -> Dict[str, float]:
        ids = self._synthetic_ids(seq_len)
        n = self.new_tokens - 1
        p, mcfg = self.params, self.mcfg

        if ccfg is not None:
            def run_prefill():
                out = llama.prefill_compressed(
                    p, ids, mcfg, ccfg, max_decode_len=self.new_tokens,
                    use_flash=self.use_flash)
                readback(out[0][:, :8])
                return out

            def loop(state):
                return llama.decode_loop(p, tok, state, n, mcfg, ccfg,
                                         use_fused=self.use_flash)[0]

            logits, state, _ = run_prefill()  # warm-up
            tok = torch.argmax(logits, dim=-1)
            readback(loop(llama.clone_decode_state(state)))
            ttft, (logits, state, stats) = timed(run_prefill, self.rtt)
            tok = torch.argmax(logits, dim=-1)
            states = [llama.clone_decode_state(state) for _ in range(3)]
            dt, _ = timed(lambda: readback(loop(states.pop())), self.rtt)
            comp = summarize_layer_stats(stats)
        else:
            pad_len = seq_len + self.new_tokens

            def run_prefill():
                out = llama.prefill_uncompressed(p, ids, mcfg,
                                                 use_flash=self.use_flash)
                readback(out[0][:, :8])
                return out

            def padded(kv):  # [L, B, S, H, D] → S padded to pad_len
                return tuple(torch.nn.functional.pad(
                    a, (0, 0, 0, 0, 0, pad_len - a.shape[2])) for a in kv)

            def loop(kvp):
                return llama.decode_loop_uncompressed(p, tok, kvp, pos, n,
                                                      mcfg)[0]

            pos = torch.full((self.batch,), seq_len, dtype=torch.int32,
                             device=self.device)
            logits, kv = run_prefill()  # warm-up
            tok = torch.argmax(logits, dim=-1)
            readback(loop(padded(kv)))
            ttft, (logits, kv) = timed(run_prefill, self.rtt)
            # Decode writes step t's K/V at seq_len + t in place, the same
            # slots in every run: the runs share one padded cache.
            kvp = padded(kv)
            del kv
            dt, _ = timed(lambda: readback(loop(kvp)), self.rtt)
            comp = None

        rec = {
            "seq_len": seq_len,
            "ttft_ms": ttft * 1e3,
            "tokens_per_second": self.batch * n / dt,
            "ms_per_step": dt * 1e3 / n,
            **device_memory_stats(self.device),
        }
        if comp:
            rec["compression_ratio"] = comp["avg_compression_ratio"]
            rec["memory_savings"] = comp["avg_memory_savings"]
        return rec

    def benchmark_single_config(self, name: str,
                                ccfg: Optional[CompressionConfig]
                                ) -> Dict[str, Any]:
        per_len = []
        for s in self.seq_lens:
            try:
                per_len.append(self.measure_single_inference(ccfg, s))
            except Exception as e:
                per_len.append({"seq_len": s, "error": repr(e)})
        ok = [r for r in per_len if "error" not in r]
        agg = {}
        for key in ("ttft_ms", "tokens_per_second", "ms_per_step"):
            vals = [r[key] for r in ok]
            if vals:
                agg[key] = {
                    "mean": statistics.mean(vals),
                    "std": statistics.pstdev(vals) if len(vals) > 1 else 0.0,
                    "min": min(vals), "max": max(vals),
                    "median": statistics.median(vals),
                }
        return {"config": name, "per_seq_len": per_len, "aggregate": agg}

    def run_full_benchmark(self, configs: Optional[Sequence[str]] = None
                           ) -> Dict[str, Any]:
        scenarios = named_scenarios(self.mcfg.num_layers)
        names = list(configs or scenarios.keys())
        for name in names:
            self.results[name] = self.benchmark_single_config(
                name, scenarios[name])
            if self.output_dir:  # intermediate save enables manual resume
                save_json(os.path.join(self.output_dir,
                                       f"benchmark_{name}.json"),
                          self.results[name])
        if self.output_dir:
            save_json(os.path.join(self.output_dir, "benchmark_results.json"),
                      self.results)
            self.plot_results()
            self.write_report()
        return self.results

    # -- analysis artifacts (plots + markdown, `benchmark runner.py`:373-552)

    def plot_results(self):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
        for name, res in self.results.items():
            ok = [r for r in res["per_seq_len"] if "error" not in r]
            if not ok:
                continue
            xs = [r["seq_len"] for r in ok]
            axes[0].plot(xs, [r["ttft_ms"] for r in ok], marker="o",
                         label=name)
            axes[1].plot(xs, [r["tokens_per_second"] for r in ok],
                         marker="o", label=name)
            if any("memory_savings" in r for r in ok):
                axes[2].plot(xs, [r.get("memory_savings", 0) for r in ok],
                             marker="o", label=name)
        for ax, title, ylab in zip(
                axes, ["TTFT vs context", "Decode throughput",
                       "KV memory savings"],
                ["ms", "tokens/s", "fraction"]):
            ax.set_title(title)
            ax.set_xlabel("sequence length")
            ax.set_ylabel(ylab)
            ax.set_xscale("log", base=2)
            ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, "benchmark_plots.png"),
                    dpi=120)
        plt.close(fig)

    def write_report(self):
        lines = ["# Compression benchmark report", "",
                 f"model: {self.mcfg.num_layers}L hidden="
                 f"{self.mcfg.hidden_size} kv_heads={self.mcfg.num_kv_heads}",
                 f"batch={self.batch} new_tokens={self.new_tokens} "
                 f"flash={self.use_flash} rtt={self.rtt*1e3:.1f}ms", ""]
        lines.append("| config | seq | TTFT (ms) | tok/s | savings |")
        lines.append("|---|---|---|---|---|")
        for name, res in self.results.items():
            for r in res["per_seq_len"]:
                if "error" in r:
                    lines.append(f"| {name} | {r['seq_len']} | error | | |")
                else:
                    lines.append(
                        f"| {name} | {r['seq_len']} | {r['ttft_ms']:.1f} | "
                        f"{r['tokens_per_second']:.1f} | "
                        f"{r.get('memory_savings', 0):.2f} |")
        with open(os.path.join(self.output_dir, "benchmark_report.md"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


def run_benchmark_suite(mcfg: ModelConfig, output_dir: str,
                        **kwargs) -> Dict[str, Any]:
    os.makedirs(output_dir, exist_ok=True)
    bench = CompressionBenchmark(mcfg, output_dir=output_dir, **kwargs)
    return bench.run_full_benchmark()
