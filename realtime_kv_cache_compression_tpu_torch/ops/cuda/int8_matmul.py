"""K4: W8A8 matmul with per-token int8 activations.

Replaces the TPU kernel `_mm_kernel` of the JAX package's
`ops/pallas/int8_matmul.py`. The CUDA source is `csrc/int8_matmul.cu`:
__dp4a int8 products into int32, a split-K GEMV for small M (decode, bound
by the weight bytes) and 128 x 128 shared-memory tiles for large M
(prefill, bound by dp4a throughput); tensor cores are later work.

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
                                                "partial")]
                + [(n, ctypes.c_int) for n in ("M", "N", "K", "split",
                                               "dtype")])


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
    for t in (x_q, w_q, x_scale, w_scale):
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError("int8 matmul: operands must be contiguous and "
                             "4-byte aligned")


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
    split, partial = 0, None
    if m <= _build.SMALL_M:
        split = _build.split_k(n, k)
        partial = torch.empty((split, m, n), dtype=torch.int32,
                              device=x_q.device)
    p = Int8MatmulParams(
        x=x_q.data_ptr(), w=w_q.data_ptr(), xs=x_scale.data_ptr(),
        ws=w_scale.data_ptr(), out=out.data_ptr(),
        partial=0 if partial is None else partial.data_ptr(),
        M=m, N=n, K=k, split=split, dtype=_build.dtype_code(out_dtype))
    _build.launch("int8_matmul_launch", p,
                  torch.cuda.current_stream(x_q.device).cuda_stream)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def dynamic_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """float activations [..., K] x int8 weights [K, N] → [..., N] in x's
    dtype: per-token activation quantization, then `int8_matmul`."""
    lead = x.shape[:-1]
    x_q, x_scale = quantize_activations(x.reshape(-1, x.shape[-1]))
    y = int8_matmul(x_q, w_q, x_scale, w_scale, out_dtype=x.dtype)
    return y.reshape(*lead, w_q.shape[1])
