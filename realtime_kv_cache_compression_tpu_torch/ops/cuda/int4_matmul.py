"""K3: fused int4 dequant-matmul over half-split, offset-binary packed codes.

Replaces the TPU kernel `_kernel` of the JAX package's
`ops/pallas/int4_matmul.py`. The CUDA source is `csrc/int4_matmul.cu`: the
codes are unpacked inside the kernel, so the weights cross device memory at
their packed 0.5 bytes per element. Three routes, picked here by shape and
type (`_route`, counted in `int4_matmul.route_launches`):

- "gemv", M <= 8 (decode), any type: a split-K GEMV bound by the packed
  bytes, its splits summed in the same launch by the last block of each
  column tile (scratch from `_build.scratch`, cached per device and
  stream);
- "tensor_core", M > 8 in bf16 where TMA can read the operands and each
  64-row step of packed rows holds whole scale groups (`_tensor_core_ok`):
  wgmma tiles bound by operations;
- "tile", every other M > 8 (float32, the parity phases' exact route, and
  the shapes the tensor-core route does not take): a float32
  shared-memory tile;
- "gemv_expert" (`int4_matmul_expert`), the GEMV over one expert of an
  `Int4ExpertTensor` stack whose id each block reads from device memory:
  MoE decode's routed experts, one launch per expert and projection, with
  no host read and no copy of the expert.

A CPU tensor takes the plain version, the JAX package's off-TPU grouped form
(`llama._matmul` for `Int4Tensor`); a CUDA tensor launches the kernel or
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build


class Int4MatmulParams(ctypes.Structure):
    """Mirror of `Int4MatmulParams` in csrc/int4_matmul.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "q", "scale", "out",
                                                "partial", "ticket")]
                + [(n, ctypes.c_int) for n in ("M", "N", "KH", "gs", "hi_off",
                                               "split", "route", "dtype")]
                + [("expert_ids", ctypes.c_void_p),
                   ("q_estride", ctypes.c_longlong),
                   ("s_estride", ctypes.c_longlong),
                   ("slot", ctypes.c_int), ("n_experts", ctypes.c_int)])


# Route, kSmallM and kMaxRange in csrc/int4_matmul.cu.
ROUTES = {"gemv": 0, "tile": 1, "tensor_core": 2}
# Counted apart; the source's kGemv with expert_ids set.
COUNTED_ROUTES = (*ROUTES, "gemv_expert")
SMALL_M = 8            # the GEMV route's rows, at most
GEMV_MAX_ROWS = 512    # packed rows a GEMV block stages x for, at most
GEMV_BLOCKS = 264      # two GEMV blocks per SM of the H100's 132: one wave
GEMV_MIN_ROWS = 64     # packed rows per GEMV block, at least (8 per warp)


def gemv_block_cols(m: int) -> int:
    """Columns one GEMV block covers at m rows (GemvShape in the source:
    32 threads x 16 columns at m <= 2, x 32 / MT above, MT = 4 or 8)."""
    return 32 * (16 if m <= 2 else 32 // (4 if m <= 4 else 8))


def _groups(kh: int, n_g: int) -> Tuple[int, int]:
    """(packed rows per scale group, scale-row offset of the high half) from
    K/2 packed rows and n_g scale rows: one row is a single group over all
    of K (both halves read row 0); otherwise each half holds n_g / 2 whole
    groups."""
    if n_g == 1:
        return kh, 0
    if n_g % 2 or kh % (n_g // 2):
        raise ValueError(f"int4 matmul: {n_g} scale rows do not split the "
                         f"{kh} packed rows into whole groups in each half")
    return kh // (n_g // 2), n_g // 2


def int4_matmul_plain(x: torch.Tensor, q_packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, as the JAX package computes it
    off the TPU: per-group dots of x with the signed codes in float32, each
    scaled by its group's scale row, summed over groups, rounded once to
    x's dtype. Materialises [M, n_g, N] float32."""
    k, n = x.shape[-1], q_packed.shape[-1]
    n_g = scale.shape[0]
    p = q_packed.to(torch.int32)  # low nibbles: rows [0, K/2); high: the rest
    codes = torch.cat([(p & 0xF) - 8, (p >> 4) - 8]).float()
    xf = x.float()
    if n_g == 1:
        return ((xf @ codes) * scale[0][None, :]).to(x.dtype)
    g = k // n_g
    y = torch.einsum("mgi,gio->mgo", xf.reshape(-1, n_g, g),
                     codes.reshape(n_g, g, n))
    return (y * scale[None]).sum(dim=1).to(x.dtype)


def _check(x, q_packed, scale) -> None:
    if not (x.is_cuda and q_packed.device == x.device
            and scale.device == x.device):
        raise ValueError("int4 matmul: inputs must be on one CUDA device")
    _build.dtype_code(x.dtype)
    if q_packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError("int4 matmul: q_packed uint8 and scale float32")
    if (x.ndim != 2 or q_packed.ndim != 2 or scale.ndim != 2
            or x.shape[1] != 2 * q_packed.shape[0]
            or scale.shape[1] != q_packed.shape[1]):
        raise ValueError(f"int4 matmul: x [M, K], q_packed [K/2, N], scale "
                         f"[n_g, N]; got {tuple(x.shape)}, "
                         f"{tuple(q_packed.shape)}, {tuple(scale.shape)}")
    if min(x.shape + q_packed.shape) == 0:
        raise ValueError("int4 matmul: empty operand")
    # x is read by element; the codes and scales by 16-byte vectors.
    for t, align in ((x, 4), (q_packed, 16), (scale, 16)):
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("int4 matmul: operands must be contiguous, x "
                             "4-byte and q_packed / scale 16-byte aligned")


def _tensor_core_ok(x, q_packed, gs: int) -> bool:
    """Whether the tensor-core route takes this call: bf16 x with more
    than SMALL_M rows; TMA's rules (16-byte aligned bases, rows of x and of
    the codes a multiple of 16 bytes, and the high half's first column of
    x on a 16-byte boundary: K % 16 == 0, N % 16 == 0); and each 64-row
    step of packed rows in one scale group, or holding whole groups of 16
    or 32 rows."""
    kh, n = q_packed.shape
    return (x.dtype == torch.bfloat16 and x.shape[0] > SMALL_M
            and x.shape[1] % 16 == 0 and n % 16 == 0
            and x.data_ptr() % 16 == 0 and q_packed.data_ptr() % 16 == 0
            and (gs == kh or gs % 64 == 0 or gs in (16, 32)))


def _route(x, q_packed, gs: int) -> str:
    if x.shape[0] <= SMALL_M:
        return "gemv"
    return "tensor_core" if _tensor_core_ok(x, q_packed, gs) else "tile"


def gemv_split(m: int, n: int, kh: int) -> int:
    """Blocks over K of the GEMV route: at most GEMV_BLOCKS blocks in all
    (one wave), each at least GEMV_MIN_ROWS packed rows and at most
    GEMV_MAX_ROWS."""
    tiles = -(-n // gemv_block_cols(m))
    split = max(1, min(GEMV_BLOCKS // tiles, kh // GEMV_MIN_ROWS))
    return max(split, -(-kh // GEMV_MAX_ROWS))


def _launch(x, q_packed, scale, route: str, **expert) -> torch.Tensor:
    """One K3 launch on `route` (q_packed / scale: one [K/2, N] / [n_g, N]
    weight; for the expert form expert 0 of the stack, with `expert` the
    ids pointer, strides, slot and count)."""
    (m, _), (kh, n) = x.shape, q_packed.shape[-2:]
    gs, hi_off = _groups(kh, scale.shape[-2])
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    split, partial, ticket = 0, None, None
    if route in ("gemv", "gemv_expert"):
        split = gemv_split(m, n, kh)
        if split > 1:
            partial, ticket = _build.scratch(x.device, stream, split * m * n,
                                             -(-n // gemv_block_cols(m)))
    p = Int4MatmulParams(
        x=x.data_ptr(), q=q_packed.data_ptr(), scale=scale.data_ptr(),
        out=out.data_ptr(),
        partial=None if partial is None else partial.data_ptr(),
        ticket=None if ticket is None else ticket.data_ptr(),
        M=m, N=n, KH=kh, gs=gs, hi_off=hi_off, split=split,
        route=ROUTES["gemv" if route == "gemv_expert" else route],
        dtype=_build.dtype_code(x.dtype), **expert)
    _build.launch("int4_matmul_launch", p, stream)
    int4_matmul.launches += 1
    int4_matmul.route_launches[route] += 1
    return out


def int4_matmul(x: torch.Tensor, q_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """[M, K] x (half-split packed [K/2, N] uint8, [n_g, N] float32 group
    scales) → [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q_packed, scale)
    _check(x, q_packed, scale)
    gs, _ = _groups(q_packed.shape[0], scale.shape[0])
    return _launch(x, q_packed, scale, _route(x, q_packed, gs))


int4_matmul.launches = 0
int4_matmul.route_launches = dict.fromkeys(COUNTED_ROUTES, 0)


def int4_matmul_expert(x: torch.Tensor, q_packed: torch.Tensor,
                       scale: torch.Tensor, ids: torch.Tensor,
                       slot: int) -> torch.Tensor:
    """[M, K] (M <= 8) x expert ids[slot] of a stack (packed [E, K/2, N]
    uint8, scales [E, n_g, N] float32) → [M, N] in x's dtype.

    `ids` is an int32 tensor of expert ids on x's device and `slot` a host
    index into it: on a CUDA tensor the kernel reads the id itself (no
    host read, no copy of the expert's weights; an id outside [0, E) traps
    on the card). A CPU tensor takes `int4_matmul_plain` on the expert's
    codes and scales."""
    if x.device.type == "cpu":
        e = int(ids.reshape(-1)[slot])
        return int4_matmul_plain(x, q_packed[e], scale[e])
    _check(x, q_packed[0], scale[0])
    if x.shape[0] > SMALL_M:
        raise ValueError(f"int4 expert matmul: at most {SMALL_M} rows, got "
                         f"{x.shape[0]}")
    if (q_packed.ndim != 3 or scale.ndim != 3
            or scale.shape[0] != q_packed.shape[0]
            or not (q_packed.is_contiguous() and scale.is_contiguous())):
        raise ValueError("int4 expert matmul: contiguous q_packed [E, K/2, "
                         "N] and scale [E, n_g, N]")
    if (ids.device != x.device or ids.dtype != torch.int32
            or not ids.is_contiguous() or not 0 <= slot < ids.numel()):
        raise ValueError("int4 expert matmul: contiguous int32 ids on x's "
                         "device, slot inside them")
    return _launch(x, q_packed, scale, "gemv_expert",
                   expert_ids=ids.data_ptr(),
                   q_estride=q_packed.stride(0), s_estride=scale.stride(0),
                   slot=slot, n_experts=q_packed.shape[0])


def int4_matmul_tensor(x: torch.Tensor, w) -> torch.Tensor:
    """`int4_matmul` of an `Int4Tensor` over any leading dims of x."""
    lead = x.shape[:-1]
    y = int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q_packed,
                    w.scale)
    return y.reshape(*lead, w.q_packed.shape[-1])
