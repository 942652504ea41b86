"""K3: fused int4 dequant-matmul over half-split, offset-binary packed codes.

Replaces the TPU kernel `_kernel` of the JAX package's
`ops/pallas/int4_matmul.py`. The CUDA source is `csrc/int4_matmul.cu`: the
codes are unpacked inside the kernel, so the weights cross device memory at
their packed 0.5 bytes per element. Small M (decode) is a split-K GEMV bound
by those bytes; large M (prefill) is a float32 shared-memory tile bound by
FMA throughput (tensor cores are later work).

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
                                                "partial")]
                + [(n, ctypes.c_int) for n in ("M", "N", "KH", "gs", "hi_off",
                                               "split", "dtype")])


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
    for t in (x, q_packed, scale):
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError("int4 matmul: operands must be contiguous and "
                             "4-byte aligned")


def int4_matmul(x: torch.Tensor, q_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """[M, K] x (half-split packed [K/2, N] uint8, [n_g, N] float32 group
    scales) → [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q_packed, scale)
    _check(x, q_packed, scale)
    (m, _), (kh, n) = x.shape, q_packed.shape
    gs, hi_off = _groups(kh, scale.shape[0])
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    split, partial = 0, None
    if m <= _build.SMALL_M:
        split = _build.split_k(n, kh)
        partial = torch.empty((split, m, n), dtype=torch.float32,
                              device=x.device)
    p = Int4MatmulParams(
        x=x.data_ptr(), q=q_packed.data_ptr(), scale=scale.data_ptr(),
        out=out.data_ptr(),
        partial=0 if partial is None else partial.data_ptr(),
        M=m, N=n, KH=kh, gs=gs, hi_off=hi_off, split=split,
        dtype=_build.dtype_code(x.dtype))
    _build.launch("int4_matmul_launch", p,
                  torch.cuda.current_stream(x.device).cuda_stream)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def int4_matmul_tensor(x: torch.Tensor, w) -> torch.Tensor:
    """`int4_matmul` of an `Int4Tensor` over any leading dims of x."""
    lead = x.shape[:-1]
    y = int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q_packed,
                    w.scale)
    return y.reshape(*lead, w.q_packed.shape[-1])
