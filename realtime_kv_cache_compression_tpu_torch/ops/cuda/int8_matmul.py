"""K4: W8A8 matmul with per-token int8 activations.

Replaces the TPU kernel `_mm_kernel` of the JAX package's
`ops/pallas/int8_matmul.py`. The CUDA source is `csrc/int8_matmul.cu`; its
int32 sums are exact, so every route equals the plain version bit for bit,
in bf16 and float32. Three routes, picked here by shape (`_route`, counted
in `int8_matmul.route_launches`):

- "gemv", M <= SMALL_M (decode): a split-K __dp4a GEMV bound by the weight
  bytes, its splits summed in the same launch by the last block of each
  column tile (scratch from `_build.scratch`, cached per device and
  stream);
- "tc", M > SMALL_M where TMA can read x and W's rows take 16-byte loads
  (K % 16 == 0, N % 16 == 0): int8 wgmma tiles of 128 x 256 outputs, the
  weights transposed to K-major in shared memory by the block, bound by
  operations;
- "tile", every other M > SMALL_M: 128 x 128 __dp4a tiles.

`quantize_activations` stays a plain torch pass outside the kernel, as it
is in JAX. `int8_matmul` takes the plain version for CPU tensors; for CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build


class Int8MatmulParams(ctypes.Structure):
    """Mirror of `Int8MatmulParams` in csrc/int8_matmul.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "w", "xs", "ws", "out",
                                                "partial", "ticket")]
                + [(n, ctypes.c_int) for n in ("M", "N", "K", "split",
                                               "route", "dtype")])


# Route, kSmallM and kMaxRange in csrc/int8_matmul.cu.
ROUTES = {"gemv": 0, "tile": 1, "tc": 2}
SMALL_M = 8            # the GEMV route's rows, at most
GEMV_MAX_ROWS = 1024   # k rows a GEMV block stages x for, at most
GEMV_BLOCKS = 264      # two GEMV blocks per SM of the H100's 132: one wave
GEMV_MIN_ROWS = 64     # k rows per GEMV block, at least (8 per warp)


def gemv_block_cols(m: int) -> int:
    """Columns one GEMV block covers at m rows (GemvShape in the source:
    32 threads x 16 columns at m <= 2, x 32 / MT above, MT = 4 or 8)."""
    return 32 * (16 if m <= 2 else 32 // (4 if m <= 4 else 8))


def gemv_split(m: int, n: int, k: int) -> int:
    """Blocks over K of the GEMV route: at most GEMV_BLOCKS blocks in all
    (one wave), each at least GEMV_MIN_ROWS rows of k and at most
    GEMV_MAX_ROWS."""
    tiles = -(-n // gemv_block_cols(m))
    split = max(1, min(GEMV_BLOCKS // tiles, k // GEMV_MIN_ROWS))
    return max(split, -(-k // GEMV_MAX_ROWS))


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x ≈ x_q * scale. x: [..., K] → (int8
    [..., K], float32 [...])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale[..., 0]


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain torch. The integer product runs in
    float64, which is exact here (|sum| <= 127^2 K << 2^53) and has a
    matmul on every device, then converts to int32 values; the epilogue
    is the kernel's: float32(acc) * x_scale[m] * w_scale[n], one rounding
    to `out_dtype`."""
    acc = (x_q.double() @ w_q.double()).to(torch.int32).float()
    return (acc * x_scale.float()[:, None]
            * w_scale.float()[None, :]).to(out_dtype)


def _check(x_q, w_q, x_scale, w_scale, out_dtype) -> None:
    dev = x_q.device
    if not (x_q.is_cuda and all(t.device == dev
                                for t in (w_q, x_scale, w_scale))):
        raise ValueError("int8 matmul: inputs must be on one CUDA device")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 matmul: x_q and w_q must be int8, got "
                        f"{x_q.dtype}/{w_q.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("int8 matmul: scales must be float32")
    _build.dtype_code(out_dtype)
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8 matmul: x_q [M, K] and w_q [K, N], got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    m, n = x_q.shape[0], w_q.shape[1]
    if x_scale.shape != (m,) or w_scale.shape != (n,):
        raise ValueError("int8 matmul: x_scale [M] and w_scale [N]")
    if min(x_q.shape + w_q.shape) == 0:
        raise ValueError("int8 matmul: empty operand")
    # TMA reads x from a 16-byte aligned base; W's rows are read as 16-byte
    # vectors and w_scale as pairs.
    for t in (x_q, w_q, x_scale, w_scale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8 matmul: operands must be contiguous and "
                             "16-byte aligned")


def _route(x_q, w_q) -> str:
    """The route a call takes, by shape alone: M <= SMALL_M the GEMV; else
    the tensor cores where TMA can read x (rows of K % 16 == 0 bytes) and
    W's rows split into 16-byte vectors (N % 16 == 0); else the dp4a
    tile."""
    (m, k), n = x_q.shape, w_q.shape[1]
    if m <= SMALL_M:
        return "gemv"
    return "tc" if k % 16 == 0 and n % 16 == 0 else "tile"


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 → [M, N] out_dtype, scaled per row
    (x_scale [M]) and per column (w_scale [N])."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype)
    _check(x_q, w_q, x_scale, w_scale, out_dtype)
    (m, k), n = x_q.shape, w_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    route = _route(x_q, w_q)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    split, partial, ticket = 0, None, None
    if route == "gemv":
        split = gemv_split(m, n, k)
        if split > 1:
            partial, ticket = _build.scratch(x_q.device, stream,
                                             split * m * n,
                                             -(-n // gemv_block_cols(m)))
    p = Int8MatmulParams(
        x=x_q.data_ptr(), w=w_q.data_ptr(), xs=x_scale.data_ptr(),
        ws=w_scale.data_ptr(), out=out.data_ptr(),
        partial=None if partial is None else partial.data_ptr(),
        ticket=None if ticket is None else ticket.data_ptr(),
        M=m, N=n, K=k, split=split, route=ROUTES[route],
        dtype=_build.dtype_code(out_dtype))
    _build.launch("int8_matmul_launch", p, stream)
    int8_matmul.launches += 1
    int8_matmul.route_launches[route] += 1
    return out


int8_matmul.launches = 0
int8_matmul.route_launches = dict.fromkeys(ROUTES, 0)


def dynamic_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """float activations [..., K] x int8 weights [K, N] → [..., N] in x's
    dtype: per-token activation quantization, then `int8_matmul`."""
    lead = x.shape[:-1]
    x_q, x_scale = quantize_activations(x.reshape(-1, x.shape[-1]))
    y = int8_matmul(x_q, w_q, x_scale, w_scale, out_dtype=x.dtype)
    return y.reshape(*lead, w_q.shape[1])
