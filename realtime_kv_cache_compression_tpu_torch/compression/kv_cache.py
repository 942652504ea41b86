"""Mixed-precision compressed KV-cache containers (PyTorch).

Port of the JAX package's `compression/kv_cache.py`, with the same tensor
layouts. Per layer: three tier pools (HIGH, MID, LOW), each a `TierCache`
with static slot capacity, codes packed sub-byte along the token axis
(ops/quantization.py), per-(token, kv-head, group) scales alongside, and
original token positions for exact RoPE and causality. Decode attends over
the pools plus an uncompressed ring of decode-time tokens (`RecentCache`).
The quantized decode pool is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def model_dtype(model_cfg: ModelConfig) -> torch.dtype:
    """The torch dtype named by `model_cfg.dtype`."""
    return _DTYPES[model_cfg.dtype]


@dataclasses.dataclass
class TierCache:
    """One precision tier's packed K/V pool.

    k_stored / v_stored: [B, ceil(N / (8/bits)), H, D] uint8 chunk-strided
      codes for bits < 16, else [B, N, H, D] raw model-dtype values.
    k_scale / k_zp / v_scale / v_zp: [B, N, H, G] float32.
    positions: [B, N] int32 original positions; valid: [B, N] bool.
    chunk: packing chunk the codes were packed with (None = one chunk).
    """

    k_stored: torch.Tensor
    v_stored: torch.Tensor
    k_scale: torch.Tensor
    k_zp: torch.Tensor
    v_scale: torch.Tensor
    v_zp: torch.Tensor
    positions: torch.Tensor
    valid: torch.Tensor
    chunk: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.positions.shape[1]


@dataclasses.dataclass
class CompressedLayerCache:
    """All tiers of one layer, ordered (HIGH, MID, LOW)."""

    tiers: Tuple[TierCache, TierCache, TierCache]

    @property
    def capacity(self) -> int:
        return sum(t.capacity for t in self.tiers)


@dataclasses.dataclass
class RecentCache:
    """Uncompressed ring of decode-time K/V tokens appended after prefill.

    k/v: [B, M, H, D] model dtype; positions: [B, M] int32; length: [B]
    int32 live count (slot i is valid iff i < length).
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    length: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_recent_cache(batch: int, max_decode_len: int,
                      model_cfg: ModelConfig, dtype=None,
                      device=None) -> RecentCache:
    dtype = dtype or model_dtype(model_cfg)
    h, d = model_cfg.num_kv_heads, model_cfg.head_dim
    return RecentCache(
        k=torch.zeros((batch, max_decode_len, h, d), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_decode_len, h, d), dtype=dtype,
                      device=device),
        positions=torch.zeros((batch, max_decode_len), dtype=torch.int32,
                              device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def append_recent(cache: RecentCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, pos_new: torch.Tensor) -> RecentCache:
    """Append one decode step's K/V ([B, 1, H, D]) into the ring, in place.

    A full ring (length == capacity) drops the append and keeps its length,
    as in the reference; it never overwrites the last slot. The ring's
    tensors are updated in place (a decode step touches one slot per row)
    and the same cache object is returned.
    """
    cap = cache.capacity
    bidx = torch.arange(cache.k.shape[0], device=cache.k.device)
    drop = cache.length >= cap                                     # [B]
    idx = torch.clamp(cache.length, max=cap - 1).long()
    keep = drop[:, None, None]
    cache.k[bidx, idx] = torch.where(keep, cache.k[bidx, idx],
                                     k_new[:, 0].to(cache.k.dtype))
    cache.v[bidx, idx] = torch.where(keep, cache.v[bidx, idx],
                                     v_new[:, 0].to(cache.v.dtype))
    cache.positions[bidx, idx] = torch.where(
        drop, cache.positions[bidx, idx], pos_new[:, 0].to(torch.int32))
    cache.length = torch.where(drop, cache.length,
                               torch.clamp(cache.length + 1, max=cap))
    return cache


def cache_storage_bytes(cache: CompressedLayerCache) -> int:
    """Physical bytes held by the layer's compressed pools."""
    total = 0
    for t in cache.tiers:
        for arr in (t.k_stored, t.v_stored, t.k_scale, t.k_zp, t.v_scale,
                    t.v_zp, t.positions, t.valid):
            total += arr.numel() * arr.element_size()
    return total
