"""Dynamic-precision KV quantization with real bit-packed storage (PyTorch).

Port of the JAX package's `ops/quantization.py`. Asymmetric uniform scheme
per (token, kv-head, channel-group): qmin=0, qmax=2^b-1,
scale=(max-min)/qmax, zp=-min/scale, with max==min mapping to scale=1,
zp=0. Codes are stored sub-byte along the token axis in the chunk-strided
layout the fused decode kernel reads: within a chunk of C tokens with
R = ceil(C / (8/bits)) byte rows, token j*R + r sits in byte row r at bit
offset j*bits. Packed bytes are byte-identical to the JAX package's: the
f32 operation order of `quantize` (x/scale + zp, then round half to even)
is the same, and `torch.round` rounds half to even like `jnp.round`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import comm
from ..config import HIGH, LOW, MID, CompressionConfig


# ---------------------------------------------------------------------------
# Precision assignment
# ---------------------------------------------------------------------------

def assign_precision(scores: torch.Tensor, cfg: CompressionConfig,
                     group=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Threshold-based precision labels: 2=HIGH, 1=MID, 0=LOW. The stats
    count the whole batch; with `group` (the data axis, each rank holding
    an equal block of its rows) the counts are summed over the group
    first, so the ratios are the whole batch's."""
    high = scores >= cfg.theta_h
    mid = (scores >= cfg.theta_m) & ~high
    labels = high.to(torch.int32) * HIGH + mid.to(torch.int32) * MID
    total = scores.numel()
    n_high = high.sum()
    n_mid = mid.sum()
    if group is not None:
        n_high, n_mid = comm.all_reduce_sum(torch.stack([n_high, n_mid]),
                                            group)
        total *= comm.rank_and_size(group)[1]
    n_low = total - n_high - n_mid
    stats = {
        "high_count": n_high, "medium_count": n_mid, "low_count": n_low,
        "high_ratio": n_high / total, "medium_ratio": n_mid / total,
        "low_ratio": n_low / total,
    }
    return labels, stats


def token_costs(labels: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """Byte-cost per token from its precision label. Built with `where`
    rather than a gather from a small table: copying the table to the
    device would block the host on every layer."""
    cost = torch.full(labels.shape, cfg.tier_cost(LOW), dtype=torch.float32,
                      device=labels.device)
    cost = torch.where(labels == MID, cfg.tier_cost(MID), cost)
    return torch.where(labels == HIGH, cfg.tier_cost(HIGH), cost)


# ---------------------------------------------------------------------------
# Quantization params / quantize / dequantize
# ---------------------------------------------------------------------------

def quant_params(x: torch.Tensor, bits: int, group_size: int,
                 clip_frac: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric uniform quant params per channel group.

    x: [..., D] with D % group_size == 0. With clip_frac > 0 the range comes
    from the (clip_frac, 1 - clip_frac) per-group order statistics instead
    of the absolute min/max. Returns (scale, zero_point), each
    [..., D // group_size] float32.
    """
    qmax = float(2 ** bits - 1)
    g = x.shape[-1] // group_size
    xg = x.reshape(*x.shape[:-1], g, group_size).float()
    if clip_frac > 0.0 and group_size > 2:
        xs = torch.sort(xg, dim=-1).values
        lo_idx = max(0, min(group_size - 1, int(clip_frac * group_size)))
        hi_idx = group_size - 1 - lo_idx
        t_min = xs[..., lo_idx]
        t_max = xs[..., hi_idx]
    else:
        t_min = xg.amin(dim=-1)
        t_max = xg.amax(dim=-1)
    degenerate = (t_max - t_min) <= 0
    one = torch.ones((), dtype=torch.float32, device=x.device)
    scale = torch.where(degenerate, one, (t_max - t_min) / qmax)
    zero_point = torch.where(degenerate, torch.zeros_like(one),
                             -t_min / scale)
    return scale, zero_point


def quantize(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             bits: int) -> torch.Tensor:
    """Quantize to integer codes in [0, 2^bits - 1], stored as uint8."""
    qmax = 2 ** bits - 1
    g = scale.shape[-1]
    group_size = x.shape[-1] // g
    xg = x.reshape(*x.shape[:-1], g, group_size).float()
    q = torch.round(xg / scale[..., None] + zero_point[..., None])
    q = q.clamp(0, qmax).to(torch.uint8)
    return q.reshape(x.shape)


def dequantize(codes_f: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(q - zp) * scale; raw 16-bit-tier values pass with scale=1, zp=0."""
    g = scale.shape[-1]
    group_size = codes_f.shape[-1] // g
    cg = codes_f.reshape(*codes_f.shape[:-1], g, group_size).float()
    out = (cg - zero_point[..., None]) * scale[..., None]
    return out.reshape(codes_f.shape).to(dtype)


# ---------------------------------------------------------------------------
# Physical bit packing
# ---------------------------------------------------------------------------

def pack_codes(codes: torch.Tensor, bits: int, axis: int = -3,
               chunk: Optional[int] = None) -> torch.Tensor:
    """Pack uint8 codes (< 2^bits) sub-byte along `axis` (the token axis).

    With R = ceil(N / (8/bits)) byte rows, token j*R + r lives in byte row r
    at bit offset j*bits. With `chunk` (a multiple of 8 // bits dividing the
    token count) the strided packing runs inside each chunk independently,
    so whole chunks map to contiguous byte rows. 8 bits is the identity;
    chunk=None zero-pads the token count to a multiple of 8 // bits.
    """
    if bits == 8:
        return codes
    axis = axis % codes.ndim
    per_byte = 8 // bits
    n = codes.shape[axis]
    shp = tuple(codes.shape)
    if chunk is not None and chunk < n:
        if chunk % per_byte or n % chunk:
            raise ValueError(f"chunk {chunk} must divide tokens {n} and be "
                             f"a multiple of {per_byte}")
        nc = n // chunk
        cg = codes.reshape(shp[:axis] + (nc, chunk) + shp[axis + 1:])
        packed = pack_codes(cg, bits, axis=axis + 1)
        return packed.reshape(shp[:axis] + (n // per_byte,) + shp[axis + 1:])
    pad = (-n) % per_byte
    if pad:
        widths = [0, 0] * (codes.ndim - 1 - axis) + [0, pad]
        codes = torch.nn.functional.pad(codes, widths)
    r = (n + pad) // per_byte
    cg = codes.reshape(shp[:axis] + (per_byte, r) + shp[axis + 1:])
    shift_shape = [1] * (codes.ndim + 1)
    shift_shape[axis] = per_byte
    shifts = (torch.arange(per_byte, dtype=torch.uint8, device=codes.device)
              * bits).reshape(shift_shape)
    # Fields never overlap, so the sum over the split axis is a bitwise OR.
    return (cg << shifts).sum(dim=axis).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, num_tokens: int,
                 axis: int = -3, chunk: Optional[int] = None) -> torch.Tensor:
    """Inverse of `pack_codes`: packed bytes → uint8 codes, [num_tokens]
    along `axis`."""
    if bits == 8:
        return packed
    axis = axis % packed.ndim
    per_byte = 8 // bits
    shp = tuple(packed.shape)
    if chunk is not None and chunk < num_tokens:
        rows_c = chunk // per_byte
        nc = shp[axis] // rows_c
        pg = packed.reshape(shp[:axis] + (nc, rows_c) + shp[axis + 1:])
        codes = unpack_codes(pg, bits, chunk, axis=axis + 1)
        return codes.reshape(shp[:axis] + (nc * chunk,) + shp[axis + 1:])
    mask = 2 ** bits - 1
    parts = [(packed >> (j * bits)) & mask for j in range(per_byte)]
    codes = torch.cat(parts, dim=axis)
    return codes.narrow(axis, 0, num_tokens)


def quantize_tier(x: torch.Tensor, bits: int, group_size: int,
                  store_dtype=torch.bfloat16, clip_frac: float = 0.0,
                  chunk: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize + physically pack one precision tier.

    x: [..., N, H, D] (packing runs along the token axis -3). bits == 16
    stores raw `store_dtype` values with unit scales. Returns
    (stored, scale, zero_point): `stored` is uint8 [..., ceil(N/(8/bits)),
    H, D] for bits < 16, else [..., N, H, D] raw; scale/zp are
    [..., N, H, D // group_size] float32.
    """
    if bits == 16:
        g = x.shape[-1] // group_size
        ones = torch.ones((*x.shape[:-1], g), dtype=torch.float32,
                          device=x.device)
        return x.to(store_dtype), ones, torch.zeros_like(ones)
    scale, zp = quant_params(x, bits, group_size, clip_frac=clip_frac)
    codes = quantize(x, scale, zp, bits)
    return pack_codes(codes, bits, axis=-3, chunk=chunk), scale, zp


def dequantize_tier(stored: torch.Tensor, scale: torch.Tensor,
                    zero_point: torch.Tensor, bits: int, dtype=torch.float32,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Unpack + dequantize one tier back to float [..., N, H, D]."""
    if bits == 16:
        return stored.to(dtype)
    num_tokens = scale.shape[-3]
    codes = unpack_codes(stored, bits, num_tokens, axis=-3, chunk=chunk)
    return dequantize(codes.float(), scale, zero_point, dtype)


def max_roundtrip_error(scale: torch.Tensor) -> torch.Tensor:
    """Upper bound on |x - dequantize(quantize(x))|: scale / 2."""
    return scale / 2.0


# ---------------------------------------------------------------------------
# Memory accounting — real bytes, not estimates
# ---------------------------------------------------------------------------

def storage_bytes(shape_tokens: int, head_dim: int, num_kv_heads: int,
                  bits: int, group_size: int, scale_bytes: int = 4) -> int:
    """Bytes that K and V codes plus their scales and zero points take for
    `shape_tokens` tokens."""
    d = head_dim * num_kv_heads
    code_bytes = (shape_tokens * d * 2 if bits == 16
                  else shape_tokens * d * bits // 8)
    param_bytes = shape_tokens * (d // group_size) * scale_bytes * 2
    return 2 * code_bytes + 2 * param_bytes

def memory_report(labels: torch.Tensor, valid: torch.Tensor,
                  cfg: CompressionConfig, head_dim: int,
                  original_tokens=None, group_size: int = 0, group=None
                  ) -> Dict[str, torch.Tensor]:
    """Per-tier element counts and compressed/original byte ratio.

    `head_dim` is the fused token-vector width; `original_tokens` the true
    pre-compression token count. Scale + zero-point bytes (float32, one pair
    per group) are charged for every stored token. With `group` (the data
    axis, each rank holding an equal block of the rows) the counts are
    summed over the group first: the ratio is the whole batch's.
    """
    lab = torch.where(valid, labels, torch.full_like(labels, -1))
    n_high = (lab == HIGH).sum()
    n_mid = (lab == MID).sum()
    n_low = (lab == LOW).sum()
    total_tokens = (original_tokens if original_tokens is not None
                    else labels.shape[-1] * labels.shape[0])
    if group is not None:
        counted = isinstance(total_tokens, torch.Tensor)
        sums = comm.all_reduce_sum(torch.stack(
            [n_high, n_mid, n_low] + ([total_tokens] if counted else [])),
            group)
        n_high, n_mid, n_low = sums[:3]
        total_tokens = (sums[3] if counted else
                        total_tokens * comm.rank_and_size(group)[1])
    original_bytes = total_tokens * head_dim * 2.0
    n_groups = head_dim // (group_size or head_dim)
    param_bytes_per_token = n_groups * 4 * 2
    n_stored = n_high + n_mid + n_low
    compressed_bytes = (
        n_high * head_dim * cfg.tier_bits(HIGH) / 8.0
        + n_mid * head_dim * cfg.tier_bits(MID) / 8.0
        + n_low * head_dim * cfg.tier_bits(LOW) / 8.0
        + n_stored * param_bytes_per_token)
    ratio = compressed_bytes / original_bytes
    return {
        "high_elements": n_high * head_dim,
        "medium_elements": n_mid * head_dim,
        "low_elements": n_low * head_dim,
        "compression_ratio": ratio,
        "memory_savings": 1.0 - ratio,
    }
