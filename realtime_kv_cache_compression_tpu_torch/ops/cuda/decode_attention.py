"""K2: fused dequant + attention decode over the packed tiers, the decode
pool and the ring.

Replaces the TPU kernel `_decode_kernel` of the JAX package's
`ops/pallas/decode_attention.py` (entry point `fused_decode_attention`):
the tier pools, the quantized (or raw 16-bit) decode pool, the recent ring,
and one or more scale groups per head (any group size of at least 8 that
divides head_dim). The CUDA source is `csrc/decode_attention.cu`.

Bound on the H100: bytes. Per kv head and stored token the kernel reads
D * bits / 8 code bytes for K and for V, plus 16 bytes of float32 scale
and zero point per scale group; at 2 bits, D = 64 and one group the scales
weigh as much as the codes. With G > 1 groups each block keeps the V
scales of its 128 tokens in shared memory as [G][128] rows (16 KB at
G = 16, 32 KB at G = 32 and head_dim 256), and every code is dequantized
in registers before its products.
The TPU kernel walks all pools in one program per batch row; on a GPU that
is one busy SM, so this kernel splits every pool into 128-token ranges over
a (split, kv head, batch) grid and merges the partial softmax states by
log-sum-exp in a second small kernel. At the main path's sizes a layer's
cache is about a megabyte, so launch latency, not bandwidth, sets its time.

A CPU tensor takes the plain version, `decode_attention_plain`
(dequantize the tiers and the pool, then `attention_over_tokens`). A CUDA
tensor launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ...compression.compressor import dequantize_layer_cache
from ...compression.kv_cache import (CompressedLayerCache, DecodePool,
                                     RecentCache, dequantize_decode_pool)
from ...config import HIGH, LOW, MID, CompressionConfig
from ..attention import attention_over_tokens
from . import _build

_HEAD_DIMS = (16, 32, 64, 128, 256)
_SPLIT_TOKENS = 128  # kTile in csrc/decode_attention.cu
_MAX_REP = 16
_MAX_SEGMENTS = 5  # kMaxSegments: HIGH, MID, LOW, decode pool, ring


class DecodeSegment(ctypes.Structure):
    """Mirror of `DecodeSegment` in csrc/decode_attention.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "k", "v", "k_scale", "k_zp", "v_scale", "v_zp", "pos", "valid",
        "length")]
                + [("rows", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in (
                    "n", "bits", "chunk", "rows_per_chunk", "split_start",
                    "n_splits")])


class DecodeParams(ctypes.Structure):
    """Mirror of `DecodeParams` in csrc/decode_attention.cu."""

    _fields_ = ([("seg", DecodeSegment * _MAX_SEGMENTS)]
                + [(n, ctypes.c_void_p) for n in (
                    "q", "q_pos", "part_acc", "part_m", "part_l", "out")]
                + [(n, ctypes.c_int) for n in (
                    "n_seg", "total_splits", "B", "Hkv", "rep", "D",
                    "dtype", "G", "gshift")]
                + [("sm_scale", ctypes.c_float)])


def decode_attention_plain(q: torch.Tensor, cache: CompressedLayerCache,
                           recent: RecentCache, q_pos: torch.Tensor,
                           cfg: CompressionConfig, dtype=torch.float32,
                           pool: DecodePool = None) -> torch.Tensor:
    """The plain version: dequantize the tiers to `dtype`, append the ring,
    then the dequantized decode pool if there is one, and attend with
    `attention_over_tokens` (the reference's plain decode order). Returns
    [B, 1, H_q, D]."""
    k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, cfg, dtype)
    rec_valid = (torch.arange(recent.capacity, device=q.device)[None]
                 < recent.length[:, None])
    ks, vs = [k_c, recent.k.to(dtype)], [v_c, recent.v.to(dtype)]
    ps, vds = [pos_c, recent.positions], [valid_c, rec_valid]
    if pool is not None:
        k_p, v_p, pos_p, valid_p = dequantize_decode_pool(pool, dtype)
        ks.append(k_p)
        vs.append(v_p)
        ps.append(pos_p)
        vds.append(valid_p)
    return attention_over_tokens(
        q, torch.cat(ks, dim=1), torch.cat(vs, dim=1), torch.cat(ps, dim=1),
        torch.cat(vds, dim=1), q_pos)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused decode: {msg}")


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _segment(seg: DecodeSegment, k, v, scales, pos, valid, length, n, bits,
             chunk, split_start, dev, q_dtype, groups: int) -> int:
    """Fill one segment; returns its number of splits. Packed segments'
    scales must be float32 [B, n, H, groups]."""
    b = pos.shape[0]
    for t in (k, v, pos) + tuple(s for s in scales if s is not None):
        _require(t.device == dev, "every tensor must be on q's device")
        _require(_aligned(t), "tensors must be contiguous and 16-byte "
                              "aligned")
    _require(pos.dtype == torch.int32 and pos.shape == (b, n),
             "positions must be int32 [B, N]")
    if bits == 16:
        _require(k.dtype == q_dtype and v.dtype == q_dtype,
                 "raw 16-bit segments must have q's dtype")
        rows_per_chunk = chunk
    else:
        _require(k.dtype == torch.uint8 and v.dtype == torch.uint8,
                 "packed codes must be uint8")
        per_byte = 8 // bits
        rows_per_chunk = -(-chunk // per_byte)
        _require(n % chunk == 0 and k.shape[1] == (n // chunk)
                 * rows_per_chunk, f"packed rows {k.shape[1]} do not match "
                                   f"{n} tokens in chunks of {chunk}")
        for s in scales:
            _require(s.dtype == torch.float32 and s.shape == (
                b, n, k.shape[2], groups), f"scales must be float32 "
                                           f"[B, N, H, {groups}]")
    seg.k, seg.v = k.data_ptr(), v.data_ptr()
    if scales[0] is not None:
        (seg.k_scale, seg.k_zp, seg.v_scale,
         seg.v_zp) = (s.data_ptr() for s in scales)
    seg.pos = pos.data_ptr()
    if valid is not None:
        _require(valid.dtype == torch.bool and valid.is_contiguous()
                 and valid.device == dev, "valid must be contiguous bool")
        seg.valid = valid.data_ptr()
    else:
        _require(length.dtype == torch.int32 and length.device == dev,
                 "ring length must be int32")
        seg.length = length.data_ptr()
    seg.rows = k.shape[1]
    seg.n, seg.bits, seg.chunk = n, bits, chunk
    seg.rows_per_chunk = rows_per_chunk
    seg.split_start = split_start
    seg.n_splits = -(-n // _SPLIT_TOKENS)
    return seg.n_splits


def _scale_groups(cache: CompressedLayerCache, pool, d: int) -> int:
    """G of the packed tiers and pool (they share cfg.quant_group_size);
    the kernel takes G = 1, or groups of a power-of-two size >= 8."""
    gs = {t.k_scale.shape[-1] for t in cache.tiers if t.capacity}
    if pool is not None and pool.n_blocks:
        gs.add(pool.k_scale.shape[-1])
    _require(len(gs) <= 1, f"tiers and pool disagree on scale groups {gs}")
    g = gs.pop() if gs else 1
    size = d // g if d % g == 0 else 0
    _require(g == 1 or (size >= 8 and size & (size - 1) == 0),
             f"scale groups of {d} / {g} channels: the kernel takes one "
             f"group per head or groups of >= 8 channels dividing head_dim")
    return g


def fused_decode_attention(q: torch.Tensor, cache: CompressedLayerCache,
                           recent: RecentCache, q_pos: torch.Tensor,
                           cfg: CompressionConfig,
                           pool: DecodePool = None) -> torch.Tensor:
    """Decode attention over the packed tier pools + the decode pool + the
    recent ring.

    q: [B, 1, H_q, D] (RoPE'd); cache: the layer's compressed pools;
    recent: the uncompressed decode ring; q_pos: [B, 1] int32 positions;
    pool: the layer's decode pool, or None. Returns [B, 1, H_q, D] in q's
    dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache, recent, q_pos, cfg,
                                      pool=pool)
    dev = q.device
    b, one, hq, d = q.shape
    groups = _scale_groups(cache, pool, d)
    _require(q.is_cuda, "q must be a CUDA tensor")
    hkv = recent.k.shape[2]
    _require(one == 1, "one query token per row")
    _require(d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0 and hq // hkv <= _MAX_REP,
             f"n_rep = Hq / Hkv must divide and be <= {_MAX_REP}")
    q = q.contiguous()
    qp = q_pos.reshape(b).to(torch.int32).contiguous()
    p = DecodeParams()
    n_seg = splits = 0
    for tier, t in zip((HIGH, MID, LOW), cache.tiers):
        if t.capacity == 0:
            continue
        bits = cfg.tier_bits(tier)
        chunk = t.chunk or cfg.tier_chunk(t.capacity) or t.capacity
        splits += _segment(
            p.seg[n_seg], t.k_stored, t.v_stored,
            (None,) * 4 if bits == 16 else (t.k_scale, t.k_zp, t.v_scale,
                                            t.v_zp),
            t.positions, t.valid, None, t.capacity, bits, chunk, splits,
            dev, q.dtype, groups)
        n_seg += 1
    if pool is not None and pool.n_blocks:
        # Each block was packed on its own: the chunk is the block.
        splits += _segment(
            p.seg[n_seg], pool.k_stored, pool.v_stored,
            (None,) * 4 if pool.bits == 16 else (
                pool.k_scale, pool.k_zp, pool.v_scale, pool.v_zp),
            pool.positions, pool.valid, None, pool.capacity, pool.bits,
            pool.block_tokens, splits, dev, q.dtype, groups)
        n_seg += 1
    if recent.capacity:
        splits += _segment(
            p.seg[n_seg], recent.k, recent.v, (None,) * 4, recent.positions,
            None, recent.length, recent.capacity, 16, recent.capacity,
            splits, dev, q.dtype, groups)
        n_seg += 1
    _require(n_seg > 0, "nothing to attend over")
    rep = hq // hkv
    part_acc = torch.empty((b, hkv, splits, rep, d), dtype=torch.float32,
                           device=dev)
    part_m = torch.empty((b, hkv, splits, rep), dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    out = torch.empty_like(q)
    p.q, p.q_pos, p.out = q.data_ptr(), qp.data_ptr(), out.data_ptr()
    p.part_acc, p.part_m = part_acc.data_ptr(), part_m.data_ptr()
    p.part_l = part_l.data_ptr()
    p.n_seg, p.total_splits, p.B, p.Hkv, p.rep, p.D = (n_seg, splits, b, hkv,
                                                       rep, d)
    p.dtype = _build.dtype_code(q.dtype)
    p.G, p.gshift = groups, (d // groups).bit_length() - 1
    p.sm_scale = 1.0 / d ** 0.5
    _build.launch("decode_attention_launch", p,
                  torch.cuda.current_stream(dev).cuda_stream)
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0
