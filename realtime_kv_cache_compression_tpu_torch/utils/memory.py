"""Memory monitoring: host RSS sampling thread + device memory statistics.

Port of the JAX package's `utils/memory.py`:
  * `device_memory_stats`: the caching allocator's current and peak
    allocated bytes (`torch.cuda.memory_stats`) and the card's total memory
    as the limit; zeros for a CPU device, as the JAX package gives zeros
    when a backend does not report.
  * `MemoryMonitor` daemon-thread sampler: psutil RSS plus the device.
  * model/KV footprint estimators.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..models.quantized_params import params_bytes


def device_memory_stats(device="cuda") -> Dict[str, float]:
    """Allocated / peak allocated / total bytes in MB of a CUDA device (0s
    for a CPU device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device_mb": 0.0, "device_peak_mb": 0.0,
                "device_limit_mb": 0.0}
    stats = torch.cuda.memory_stats(device)
    total = torch.cuda.get_device_properties(device).total_memory
    return {
        "device_mb": stats.get("allocated_bytes.all.current", 0) / 2**20,
        "device_peak_mb": stats.get("allocated_bytes.all.peak", 0) / 2**20,
        "device_limit_mb": total / 2**20,
    }


class MemoryMonitor:
    """Background sampler of host RSS + device memory at a fixed interval."""

    def __init__(self, interval_s: float = 0.1, device="cuda"):
        self.interval_s = interval_s
        self.device = device
        self.samples: List[Dict[str, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self) -> Dict[str, float]:
        rec: Dict[str, float] = {"t": time.time()}
        try:
            import psutil

            rec["rss_mb"] = psutil.Process().memory_info().rss / 2**20
        except ImportError:
            rec["rss_mb"] = 0.0
        rec.update(device_memory_stats(self.device))
        return rec

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(self._sample())
            self._stop.wait(self.interval_s)

    def start(self):
        self.samples = []
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> Dict[str, float]:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self.samples.append(self._sample())
        return self.summary()

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        keys = [k for k in self.samples[0] if k != "t"]
        out = {}
        for k in keys:
            vals = [s[k] for s in self.samples]
            out[f"peak_{k}"] = max(vals)
            out[f"avg_{k}"] = sum(vals) / len(vals)
        out["num_samples"] = len(self.samples)
        return out


def model_footprint_mb(params: Any) -> float:
    """Bytes held by a params tree, quantized weights' codes and scales
    included (memory_utils.py:83-92 parity)."""
    return params_bytes(params) / 2**20


def kv_cache_bytes(batch: int, seq_len: int, num_layers: int,
                   num_kv_heads: int, head_dim: int,
                   bytes_per_el: int = 2) -> int:
    """Vanilla KV-cache footprint: 2·B·S·L·H·D·bytes
    (memory_utils.py:94-105)."""
    return 2 * batch * seq_len * num_layers * num_kv_heads * head_dim * bytes_per_el
