"""Mixed-precision compressed KV-cache containers (PyTorch).

Port of the JAX package's `compression/kv_cache.py`, with the same tensor
layouts. Per layer: three tier pools (HIGH, MID, LOW), each a `TierCache`
with static slot capacity, codes packed sub-byte along the token axis
(ops/quantization.py), per-(token, kv-head, group) scales alongside, and
original token positions for exact RoPE and causality. Decode attends over
the pools plus an uncompressed ring of decode-time tokens (`RecentCache`)
and, for generations longer than the ring, the quantized decode pool
(`DecodePool`) that full rings flush into. `cache_storage_bytes` and
`layer_cache_report` count the bytes a layer's pools hold against the dense
cache's (`uncompressed_kv_bytes`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import CompressionConfig, ModelConfig
from ..ops.quantization import dequantize_tier, quantize_tier

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


@dataclasses.dataclass
class DecodePool:
    """Quantized decode-token pool: a ring of ring-sized blocks.

    Each time a row's recent ring fills with R tokens, `flush_recent`
    quantizes the whole ring at `bits` into the row's next block; with all
    `n_blocks` full the oldest block is overwritten (a sliding window over
    decode tokens; the prefill tiers are never evicted). Shapes (W =
    n_blocks, R = block_tokens = ring capacity, Rw = R * bits / 8):
      k_stored / v_stored: [B, W * Rw, H, D] uint8, each block packed on
        its own (one chunk of R tokens), or [B, W * R, H, D] raw model
        dtype for bits == 16;
      k_scale / k_zp / v_scale / v_zp: [B, W * R, H, G] float32;
      positions: [B, W * R] int32; valid: [B, W * R] bool;
      write_block: [B] int32, the next block to write (wraps mod W).
    """

    k_stored: torch.Tensor
    v_stored: torch.Tensor
    k_scale: torch.Tensor
    k_zp: torch.Tensor
    v_scale: torch.Tensor
    v_zp: torch.Tensor
    positions: torch.Tensor
    valid: torch.Tensor
    write_block: torch.Tensor
    n_blocks: int = 0
    block_tokens: int = 0
    bits: int = 4

    @property
    def capacity(self) -> int:
        return self.n_blocks * self.block_tokens


def init_decode_pool(batch: int, ring_capacity: int, cfg: CompressionConfig,
                     model_cfg: ModelConfig,
                     device=None) -> Optional[DecodePool]:
    """Allocate the decode pool (None when decode_pool_blocks == 0)."""
    w = cfg.decode_pool_blocks
    if w == 0:
        return None
    bits = cfg.decode_pool_bits
    h, d = model_cfg.num_kv_heads, model_cfg.head_dim
    g = d // (cfg.quant_group_size or d)
    r = ring_capacity
    per_byte = 1 if bits >= 8 else 8 // bits
    if bits < 16 and r % per_byte:
        raise ValueError(f"ring capacity {r} must divide {per_byte} "
                         f"tokens/byte for {bits}-bit decode pool packing")
    rows = r if bits == 16 else r // per_byte
    store = model_dtype(model_cfg) if bits == 16 else torch.uint8

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return DecodePool(
        k_stored=full((batch, w * rows, h, d), 0, store),
        v_stored=full((batch, w * rows, h, d), 0, store),
        k_scale=full((batch, w * r, h, g), 1.0, torch.float32),
        k_zp=full((batch, w * r, h, g), 0.0, torch.float32),
        v_scale=full((batch, w * r, h, g), 1.0, torch.float32),
        v_zp=full((batch, w * r, h, g), 0.0, torch.float32),
        positions=full((batch, w * r), 0, torch.int32),
        valid=full((batch, w * r), False, torch.bool),
        write_block=full((batch,), 0, torch.int32),
        n_blocks=w, block_tokens=r, bits=bits)


def flush_recent(recent: RecentCache, pool: DecodePool,
                 cfg: CompressionConfig, model_cfg: ModelConfig
                 ) -> Tuple[RecentCache, DecodePool]:
    """Flush full ring rows into the decode pool, in place.

    Rows whose ring is full (length == capacity) have their R tokens
    quantized at the pool's bits and written into their next block, and
    their ring length resets to 0; other rows are unchanged. As in the
    reference, every row's ring is quantized and the result applied by
    masking, so the call reads no device value on the host. The pool's and
    the ring's tensors are updated in place and the same objects returned.
    """
    b, r = recent.k.shape[0], recent.capacity
    group_size = cfg.quant_group_size or model_cfg.head_dim
    store_dtype = model_dtype(model_cfg)
    full = recent.length >= r                                      # [B]
    k_new, k_scale, k_zp = quantize_tier(recent.k, pool.bits, group_size,
                                         store_dtype,
                                         clip_frac=cfg.quant_clip_frac)
    v_new, v_scale, v_zp = quantize_tier(recent.v, pool.bits, group_size,
                                         store_dtype,
                                         clip_frac=cfg.quant_clip_frac)
    rows = k_new.shape[1]                                # rows per block
    dev = recent.k.device
    bidx = torch.arange(b, device=dev)[:, None]
    w = pool.write_block.long()
    row_idx = w[:, None] * rows + torch.arange(rows, device=dev)[None, :]
    tok_idx = w[:, None] * r + torch.arange(r, device=dev)[None, :]

    def upd(dst, src, idx):
        mask = full.reshape((b,) + (1,) * (src.dim() - 1))
        dst[bidx, idx] = torch.where(mask, src.to(dst.dtype), dst[bidx, idx])

    upd(pool.k_stored, k_new, row_idx)
    upd(pool.v_stored, v_new, row_idx)
    upd(pool.k_scale, k_scale, tok_idx)
    upd(pool.k_zp, k_zp, tok_idx)
    upd(pool.v_scale, v_scale, tok_idx)
    upd(pool.v_zp, v_zp, tok_idx)
    upd(pool.positions, recent.positions, tok_idx)
    upd(pool.valid, torch.ones((b, r), dtype=torch.bool, device=dev),
        tok_idx)
    pool.write_block = torch.where(
        full, (pool.write_block + 1) % pool.n_blocks, pool.write_block)
    recent.length = torch.where(full, torch.zeros_like(recent.length),
                                recent.length)
    return recent, pool


def dequantize_decode_pool(pool: DecodePool, dtype=torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Materialize the pool to dense K/V: (k, v, positions, valid), k/v
    [B, W * R, H, D]. Blocks were packed one by one, so they unpack one by
    one (a reshape, no data movement)."""
    b = pool.positions.shape[0]
    w, r = pool.n_blocks, pool.block_tokens
    h, d = pool.k_stored.shape[-2:]
    g = pool.k_scale.shape[-1]

    def deq(stored, scale, zp):
        out = dequantize_tier(stored.reshape(b, w, -1, h, d),
                              scale.reshape(b, w, r, h, g),
                              zp.reshape(b, w, r, h, g), pool.bits, dtype)
        return out.reshape(b, w * r, h, d)

    return (deq(pool.k_stored, pool.k_scale, pool.k_zp),
            deq(pool.v_stored, pool.v_scale, pool.v_zp),
            pool.positions, pool.valid)


def cache_storage_bytes(cache: CompressedLayerCache) -> int:
    """Physical bytes held by the layer's compressed pools."""
    total = 0
    for t in cache.tiers:
        for arr in (t.k_stored, t.v_stored, t.k_scale, t.k_zp, t.v_scale,
                    t.v_zp, t.positions, t.valid):
            total += arr.numel() * arr.element_size()
    return total


def uncompressed_kv_bytes(batch: int, seq_len: int, model_cfg: ModelConfig,
                          bytes_per_el: int = 2) -> int:
    """Bytes a dense bf16 K/V cache would hold for the same tokens."""
    return (2 * batch * seq_len * model_cfg.num_kv_heads * model_cfg.head_dim
            * bytes_per_el)


def layer_cache_report(cache: CompressedLayerCache, batch: int, seq_len: int,
                       model_cfg: ModelConfig) -> Dict[str, float]:
    """One layer's allocated storage against the dense cache's."""
    compressed = cache_storage_bytes(cache)
    original = uncompressed_kv_bytes(batch, seq_len, model_cfg)
    return {
        "compressed_bytes": compressed,
        "original_bytes": original,
        "allocated_ratio": compressed / original,
        "allocated_savings": 1.0 - compressed / original,
    }
