"""K1: causal flash-attention prefill with the prompt-mass side channel.

Replaces the TPU kernel `_flash_kernel` of the JAX package's
`ops/pallas/flash_prefill.py` in its square causal mode (a), entry point
`flash_prefill_with_prompt_mass`, and its rectangular chunked mode (b),
`flash_chunk_attention_with_prompt_mass`; the ring-pair (c) and positioned
(d) modes are not ported yet. The CUDA source is `csrc/flash_prefill.cu`;
one kernel serves both modes, mode (a) being q_offset = 0 over its own
keys.

Bound on the H100: at d=64 the first version is bound by float32 FMA issue
and shared-memory broadcast reads (scalar FMAs, one thread per query row),
not by memory: K/V tiles are staged once per 128 query rows. Its design
answers the TPU kernel's memory concern the same way (the S x S matrix
never exists, the prompt mass rides as one more online-softmax sum), and
leaves the tensor cores to later work.

A CPU tensor takes the plain version, `ops.attention.
prefill_attention_with_prompt_mass` or `chunk_attention_with_prompt_mass`.
A CUDA tensor launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..attention import (chunk_attention_with_prompt_mass,
                         prefill_attention_with_prompt_mass)
from . import _build

_HEAD_DIMS = (16, 32, 64, 128)


class FlashParams(ctypes.Structure):
    """Mirror of `FlashParams` in csrc/flash_prefill.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "pm",
                                                "plen")]
                + [(n, ctypes.c_longlong) for n in (
                    "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh",
                    "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S_q", "S_k", "q_offset", "Hq", "Hkv", "D",
                    "dtype")]
                + [("sm_scale", ctypes.c_float)])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int = 0) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash prefill: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash prefill: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError("flash prefill: q [B,S_q,Hq,D], k/v [B,S_k,Hkv,D]")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash prefill: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if q_offset < 0 or q_offset + s > k.shape[1]:
        raise ValueError(f"flash prefill: rows {q_offset}..{q_offset + s} "
                         f"lie outside the {k.shape[1]}-row key buffer")
    if hq % k.shape[2]:
        raise ValueError("flash prefill: Hq must be a multiple of Hkv")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash prefill: head_dim {d} not in {_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash prefill: the head_dim axis must be "
                         "contiguous")


def _launch(q, k, v, q_offset: int, prompt_len: int, prompt_lens):
    """Checks, allocates and launches K1; returns (out, prompt mass)."""
    _check(q, k, v, q_offset)
    b, s_q, hq, d = q.shape
    if prompt_lens is None:
        plen = torch.full((b,), prompt_len, dtype=torch.int32,
                          device=q.device)
    else:
        plen = torch.clamp(prompt_lens.to(device=q.device,
                                          dtype=torch.int32),
                           max=prompt_len).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    pm = torch.empty((b, hq, s_q), dtype=torch.float32, device=q.device)
    p = FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
        pm=pm.data_ptr(), plen=plen.data_ptr(),
        q_sb=q.stride(0), q_ss=q.stride(1), q_sh=q.stride(2),
        k_sb=k.stride(0), k_ss=k.stride(1), k_sh=k.stride(2),
        v_sb=v.stride(0), v_ss=v.stride(1), v_sh=v.stride(2),
        o_sb=out.stride(0), o_ss=out.stride(1), o_sh=out.stride(2),
        B=b, S_q=s_q, S_k=k.shape[1], q_offset=q_offset, Hq=hq,
        Hkv=k.shape[2], D=d, dtype=_build.dtype_code(q.dtype),
        sm_scale=1.0 / d ** 0.5)
    _build.launch("flash_prefill_launch", p,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out, pm.mean(dim=1)


def flash_prefill_with_prompt_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_len: int,
    prompt_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mode (a): causal attention + prompt attention mass, the contract of
    `prefill_attention_with_prompt_mass`.

    q: [B, S, H_q, D]; k, v: [B, S, H_kv, D]; prompt_lens: optional [B]
    per-row prompt lengths <= prompt_len. Returns (out [B, S, H_q, D] in q's
    dtype, prompt_mass [B, S] float32 averaged over heads).
    """
    if q.device.type == "cpu":
        return prefill_attention_with_prompt_mass(q, k, v, prompt_len,
                                                  prompt_lens=prompt_lens)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash prefill: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    result = _launch(q, k, v, 0, prompt_len, prompt_lens)
    flash_prefill_with_prompt_mass.launches += 1
    return result


def flash_chunk_attention_with_prompt_mass(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    q_offset: int,
    prompt_len: int,
    prompt_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mode (b): one prefill chunk over the position-ordered KV buffer, the
    contract of `chunk_attention_with_prompt_mass`.

    q: [B, c, H_q, D] at positions q_offset .. q_offset + c - 1 (a host
    int: the chunk loop runs on the host); k_buf, v_buf: [B, S, H_kv, D]
    with the chunk written, q_offset + c <= S. Returns (out [B, c, H_q, D]
    in q's dtype, prompt_mass [B, c] float32).
    """
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return chunk_attention_with_prompt_mass(q, k_buf, v_buf, q_offset,
                                                prompt_len,
                                                prompt_lens=prompt_lens)
    result = _launch(q, k_buf, v_buf, q_offset, prompt_len, prompt_lens)
    flash_chunk_attention_with_prompt_mass.launches += 1
    return result


flash_prefill_with_prompt_mass.launches = 0
flash_chunk_attention_with_prompt_mass.launches = 0
