"""K2: fused dequant + attention decode over the packed tiers, the decode
pool and the ring.

Replaces the TPU kernel `_decode_kernel` of the JAX package's
`ops/pallas/decode_attention.py` (entry point `fused_decode_attention`):
the tier pools, the quantized (or raw 16-bit) decode pool, the recent ring,
and one or more scale groups per head (any group size of at least 8 that
divides head_dim). The CUDA source is `csrc/decode_attention.cu`.

Bound on the H100: bytes, and at the main path's sizes (0.3-13 MB per
layer) the launch and the chain of dependent loads in a block. The grid is
(splits, kv heads, batch): `_plan_splits` cuts every segment into ranges
of whole tiles, as few tiles a split as keep a layer within TARGET_BLOCKS
blocks (at most MAX_SPLITS_PER_HEAD per batch row and kv head); a block
stages its rows tile by tile into shared memory (`_tile_rows`, within the
limits the library reports through `decode_attention_limits`), reads
each packed byte row once for all the tokens it holds, and the last block
of each (batch row, kv head) merges the splits' partial softmax states by
log-sum-exp in the same launch. Its scratch (partials and tickets) is
cached per device and stream (`_build.scratch`); a call allocates only
its output. bf16 at one scale group per head folds the affine
dequantization into rank-1 corrections of the code sums, as the reference
does; float32 dequantizes each code before its products, since the fold's
cancellation costs float32 the digits its parity with the plain version
needs on a trained model's activations.

The lse mode (`return_lse=True`) is the same kernel with a second
epilogue: the merging block also writes each row's log-sum-exp and keeps
O / L in float32, so that a rank's partial over its own slots of a
sequence-sharded state merges exactly with the other ranks'
(`parallel.seq_parallel.merge_slot_partials`); the ring may be left out.

A CPU tensor takes the plain version, `decode_attention_plain`
(dequantize the tiers and the pool, then `attention_over_tokens`). A CUDA
tensor launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...compression.compressor import dequantize_layer_cache
from ...compression.kv_cache import (CompressedLayerCache, DecodePool,
                                     RecentCache, dequantize_decode_pool)
from ...config import HIGH, LOW, MID, CompressionConfig
from ..attention import attention_over_tokens
from . import _build

_HEAD_DIMS = (16, 32, 64, 128, 256)
_MAX_REP = 16
_MAX_SEGMENTS = 5  # kMaxSegments: HIGH, MID, LOW, decode pool, ring
# The split plan: blocks a layer aims at, splits per (row, kv head).
TARGET_BLOCKS = 264     # two blocks per SM of the H100's 132
MAX_SPLITS_PER_HEAD = 32


class DecodeLimits(ctypes.Structure):
    """Mirror of `DecodeLimits` in csrc/decode_attention.cu: a tile's
    tokens, bytes of K rows (and of V rows) and tokens x scale groups (G >
    1), each at most; splits per (batch row, kv head) the kernel takes."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "tile_tokens", "tile_bytes", "grouped_scales", "max_splits")]


@functools.lru_cache(maxsize=None)
def kernel_limits() -> DecodeLimits:
    """The limits the built kernel holds tiles and splits to. Builds the
    library if needed."""
    lim = DecodeLimits()
    _build.load_library().lib.decode_attention_limits(ctypes.byref(lim))
    return lim


class DecodeSegment(ctypes.Structure):
    """Mirror of `DecodeSegment` in csrc/decode_attention.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "k", "v", "k_scale", "k_zp", "v_scale", "v_zp", "pos", "valid",
        "length")]
                + [("rows", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in (
                    "n", "bits", "chunk", "rows_per_chunk", "split_start",
                    "n_splits", "rows_per_split", "tile_rows")])


class DecodeParams(ctypes.Structure):
    """Mirror of `DecodeParams` in csrc/decode_attention.cu."""

    _fields_ = ([("seg", DecodeSegment * _MAX_SEGMENTS)]
                + [(n, ctypes.c_void_p) for n in (
                    "q", "q_pos", "part_acc", "part_m", "part_l", "ticket",
                    "out", "lse")]
                + [(n, ctypes.c_int) for n in (
                    "n_seg", "total_splits", "B", "Hkv", "rep", "D",
                    "dtype", "G", "gshift")]
                + [("sm_scale", ctypes.c_float)])


def decode_attention_plain(q: torch.Tensor, cache: CompressedLayerCache,
                           recent: Optional[RecentCache], q_pos: torch.Tensor,
                           cfg: CompressionConfig, dtype=torch.float32,
                           pool: DecodePool = None, return_lse: bool = False):
    """The plain version: dequantize the tiers to `dtype`, append the ring
    (None: no ring), then the dequantized decode pool if there is one, and
    attend with `attention_over_tokens` (the reference's plain decode
    order). Returns [B, 1, H_q, D]; with `return_lse`, (that output in
    float32, the log-sum-exp [B, H_q, 1] float32, -inf on rows that see no
    key), as the kernel's lse mode."""
    k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, cfg, dtype)
    ks, vs, ps, vds = [k_c], [v_c], [pos_c], [valid_c]
    if recent is not None:
        ks.append(recent.k.to(dtype))
        vs.append(recent.v.to(dtype))
        ps.append(recent.positions)
        vds.append(torch.arange(recent.capacity, device=q.device)[None]
                   < recent.length[:, None])
    if pool is not None:
        k_p, v_p, pos_p, valid_p = dequantize_decode_pool(pool, dtype)
        ks.append(k_p)
        vs.append(v_p)
        ps.append(pos_p)
        vds.append(valid_p)
    return attention_over_tokens(
        q, torch.cat(ks, dim=1), torch.cat(vs, dim=1), torch.cat(ps, dim=1),
        torch.cat(vds, dim=1), q_pos, return_lse=return_lse)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused decode: {msg}")


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _tile_rows(bits: int, row_bytes: int, groups: int,
               lim: DecodeLimits) -> int:
    """Byte rows of a segment one tile holds: at most lim.tile_tokens
    tokens (8 / bits per packed row), lim.tile_bytes of K rows, and, with
    G > 1 scale groups, lim.grouped_scales tokens x groups."""
    per = 1 if bits == 16 else 8 // bits
    tokens = (lim.tile_tokens if bits == 16 or groups == 1
              else min(lim.tile_tokens, lim.grouped_scales // groups))
    return max(1, min(tokens // per, lim.tile_bytes // row_bytes))


def _segment(seg: DecodeSegment, k, v, scales, pos, valid, length, n, bits,
             chunk, dev, q_dtype, groups: int) -> None:
    """Fill one segment but its splits. Packed segments' scales must be
    float32 [B, n, H, groups]."""
    b, d = pos.shape[0], k.shape[-1]
    for t in (k, v, pos) + tuple(s for s in scales if s is not None):
        _require(t.device == dev, "every tensor must be on q's device")
        _require(_aligned(t), "tensors must be contiguous and 16-byte "
                              "aligned")
    _require(pos.dtype == torch.int32 and pos.shape == (b, n),
             "positions must be int32 [B, N]")
    if bits == 16:
        _require(k.dtype == q_dtype and v.dtype == q_dtype,
                 "raw 16-bit segments must have q's dtype")
        # One token per row: the whole segment is one chunk.
        chunk = rows_per_chunk = n
        row_bytes = d * k.element_size()
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
        row_bytes = d
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
    seg.tile_rows = _tile_rows(bits, row_bytes, groups, kernel_limits())


def _plan_splits(segs, b: int, hkv: int) -> int:
    """Cut the segments into splits of at most k whole tiles each (ranges
    of byte rows; a tile holds at most `tile_rows` rows of one chunk):
    the least k that keeps the splits per (batch row, kv head) within
    TARGET_BLOCKS / (B Hkv), at most MAX_SPLITS_PER_HEAD (or one per
    segment). Every block then walks about the same number of tiles, which
    sets its time. Sets each segment's split_start, rows_per_split and
    n_splits; returns the total."""
    target = max(len(segs), min(MAX_SPLITS_PER_HEAD,
                                TARGET_BLOCKS // (b * hkv)))
    units = [min(seg.tile_rows, seg.rows_per_chunk) for seg in segs]
    tiles = [-(-seg.rows // u) for seg, u in zip(segs, units)]
    k = max(1, -(-sum(tiles) // target))
    while sum(-(-t // k) for t in tiles) > target:
        k += 1
    start = 0
    for seg, unit, n_tiles in zip(segs, units, tiles):
        seg.rows_per_split = k * unit
        seg.n_splits = -(-n_tiles // k)
        seg.split_start = start
        start += seg.n_splits
    return start


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
                           recent: Optional[RecentCache], q_pos: torch.Tensor,
                           cfg: CompressionConfig, pool: DecodePool = None,
                           return_lse: bool = False):
    """Decode attention over the packed tier pools + the decode pool + the
    recent ring.

    q: [B, 1, H_q, D] (RoPE'd); cache: the layer's compressed pools;
    recent: the uncompressed decode ring, or None (a slot shard's call on
    every rank but the one that adds the replicated ring); q_pos: [B, 1]
    int32 positions; pool: the layer's decode pool, or None. Returns
    [B, 1, H_q, D] in q's dtype. With `return_lse` (the lse mode: a
    partial over one rank's slots, to be merged with the others' by
    log-sum-exp) returns (out [B, 1, H_q, D] float32, lse [B, H_q, 1]
    float32, -inf on rows that see no key); its launches count on
    `fused_decode_attention.lse_launches`, the default call's on
    `.launches`.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache, recent, q_pos, cfg,
                                      pool=pool, return_lse=return_lse)
    dev = q.device
    b, one, hq, d = q.shape
    groups = _scale_groups(cache, pool, d)
    _require(q.is_cuda, "q must be a CUDA tensor")
    live = [t for t in cache.tiers if t.capacity]
    _require(recent is not None or live, "nothing to attend over")
    hkv = (recent.k if recent is not None else live[0].k_stored).shape[2]
    _require(one == 1, "one query token per row")
    _require(d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0 and hq // hkv <= _MAX_REP,
             f"n_rep = Hq / Hkv must divide and be <= {_MAX_REP}")
    q = q.contiguous()
    qp = q_pos.reshape(b).to(torch.int32).contiguous()
    p = DecodeParams()
    segs = []
    for tier, t in zip((HIGH, MID, LOW), cache.tiers):
        if t.capacity == 0:
            continue
        bits = cfg.tier_bits(tier)
        chunk = t.chunk or cfg.tier_chunk(t.capacity) or t.capacity
        segs.append(p.seg[len(segs)])
        _segment(
            segs[-1], t.k_stored, t.v_stored,
            (None,) * 4 if bits == 16 else (t.k_scale, t.k_zp, t.v_scale,
                                            t.v_zp),
            t.positions, t.valid, None, t.capacity, bits, chunk, dev,
            q.dtype, groups)
    if pool is not None and pool.n_blocks:
        # Each block was packed on its own: the chunk is the block.
        segs.append(p.seg[len(segs)])
        _segment(
            segs[-1], pool.k_stored, pool.v_stored,
            (None,) * 4 if pool.bits == 16 else (
                pool.k_scale, pool.k_zp, pool.v_scale, pool.v_zp),
            pool.positions, pool.valid, None, pool.capacity, pool.bits,
            pool.block_tokens, dev, q.dtype, groups)
    if recent is not None and recent.capacity:
        segs.append(p.seg[len(segs)])
        _segment(
            segs[-1], recent.k, recent.v, (None,) * 4, recent.positions,
            None, recent.length, recent.capacity, 16, recent.capacity, dev,
            q.dtype, groups)
    _require(segs, "nothing to attend over")
    splits = _plan_splits(segs, b, hkv)
    rep = hq // hkv
    rep_inst = 1 << (rep - 1).bit_length()  # the kernel instance's n_rep
    n_part = b * hkv * splits * rep_inst
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, ticket = _build.scratch(dev, stream, n_part * (d + 2), b * hkv)
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else None)
    lse = (torch.empty((b, hq, 1), dtype=torch.float32, device=dev)
           if return_lse else None)
    p.q, p.q_pos, p.out = q.data_ptr(), qp.data_ptr(), out.data_ptr()
    p.lse = lse.data_ptr() if return_lse else None
    p.part_acc = part.data_ptr()
    p.part_m = p.part_acc + 4 * n_part * d
    p.part_l = p.part_m + 4 * n_part
    p.ticket = ticket.data_ptr()
    p.n_seg, p.total_splits, p.B, p.Hkv, p.rep, p.D = (len(segs), splits, b,
                                                       hkv, rep, d)
    p.dtype = _build.dtype_code(q.dtype)
    p.G, p.gshift = groups, (d // groups).bit_length() - 1
    p.sm_scale = 1.0 / d ** 0.5
    _build.launch("decode_attention_launch", p, stream)
    if return_lse:
        fused_decode_attention.lse_launches += 1
        return out, lse
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0
fused_decode_attention.lse_launches = 0
