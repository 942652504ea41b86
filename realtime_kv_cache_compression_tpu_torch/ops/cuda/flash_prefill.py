"""K1: flash-attention prefill with the prompt-mass side channel.

Replaces the TPU kernel `_flash_kernel` of the JAX package's
`ops/pallas/flash_prefill.py` in all four modes, one CUDA kernel
template (`csrc/flash_prefill.cuh`) with the mode as a template
parameter, each mode instantiated in its own source
(`csrc/flash_prefill.cu`: the causal modes and the C entries,
`flash_prefill_pair.cu`: (c), `flash_prefill_positioned.cu`: (d)) so that
they build in parallel:

- (a) square causal, `flash_prefill_with_prompt_mass`;
- (b) rectangular causal at `q_offset`, `flash_chunk_attention_with_
  prompt_mass`;
- the diagonal pair, mode (a) with the log-sum-exp output and a per-row
  local prompt length, `flash_pair_attention(causal=True)`, counted as
  `flash_diagonal_pair_attention`;
- (c) non-causal pair, `flash_pair_attention(causal=False)`, counted as
  `flash_full_pair_attention`;
- (d) positioned keys, `flash_positioned_attention`: pool slots at
  arbitrary global positions, invalid ones at `POS_SENTINEL`.

`merge_attention_partials` merges pair/positioned partials exactly by
log-sum-exp, and `flash_compressed_prefix_attention` is the
compressed-prefix chunked prefill's attention: mode (d) over the
dequantized pools, the diagonal pair over the chunk itself, merged.

Two routes, by dtype, both hand-written kernels:
- bf16 (`csrc/flash_prefill_tc.cuh`): wgmma tiles on the tensor cores
  over Q, K and V staged by TMA, float32 scores, softmax statistics and
  prompt mass, P rounded to bf16 for the value product (as the TPU kernel
  rounds p to v's dtype). Bound: operations. TMA reads q, k and v through
  tensor maps of their strided views, so each needs a 16-byte aligned base
  and strides that are multiples of 8 elements (the column slices of the
  fused QKV projection are); `_check` refuses any other view.
- float32: the scalar-FMA kernel (one thread per query row; four at
  head_dim 256), which the float32 parity phases need: tensor cores would
  round float32 to TF32.

A CPU tensor takes the plain version: `ops.attention.
prefill_attention_with_prompt_mass` or `chunk_attention_with_prompt_mass`
for modes (a) and (b), `pair_attention_plain` and
`positioned_attention_plain` (beside the wrappers here) for the others.
A CUDA tensor launches the kernel or raises; there is no fallback.

Tuning surface, as JAX's wrappers have it (`kernel_autotune` sweeps it):
every wrapper takes `block_q` / `block_k`, the tensor-core tile's query
rows and keys (`resolve_tile`: None is the kernel's own tile; a value
that is not a power of two raises ValueError, one past the sequence is
clamped to it as JAX clamps, and a tile the build lacks, `built_tiles`,
raises ValueError naming those it has; never another tile instead), and
mode (a) takes JAX's three variants, `fold_gqa`, `exp_bf16` and
`stats_via_mxu` (`csrc/flash_prefill_tc.cuh`). The defaults run the
kernel every path uses; no caller in the package passes them. A CPU tensor runs the
same checks and then the plain version (a tile does not change the
function; `exp_bf16` does, and the plain version takes it too). Each
wrapper counts its launches by the instance that ran in `tile_launches`
(a (rows, keys) tile of the tensor-core route, or "float32") and by
variant name in `variant_launches`, beside `launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..attention import (chunk_attention_with_prompt_mass, head_mean,
                         prefill_attention_with_prompt_mass)
from . import _build

_HEAD_DIMS = (16, 32, 64, 128, 256)
_CAUSAL, _FULL, _POSITIONED = 0, 1, 2  # Mode in csrc/flash_prefill.cuh
_MODE_NAMES = {_CAUSAL: "causal", _FULL: "full", _POSITIONED: "positioned"}
# Mode (a)'s variants, tc::Variant in csrc/flash_prefill_tc.cuh.
VARIANT_FLAGS = (("fold_gqa", 1), ("exp_bf16", 2), ("stats_via_mxu", 4))
_FOLD, _EXP_BF16, _STATS_MXU = (flag for _, flag in VARIANT_FLAGS)
_TILE_SIDES = (64, 128)   # rows and keys of a non-default tile
_TILE_HEAD_DIMS = (64, 128)
_SCALAR_SUB_KEYS = 16     # keys per running-maximum step of the float32 route

# Position of an invalid pool slot: above every query position, so it is
# never visible and never a prompt column (decode_attention / kv_cache use
# the same value in the JAX package).
POS_SENTINEL = 1 << 30

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class FlashParams(ctypes.Structure):
    """Mirror of `FlashParams` in csrc/flash_prefill.cuh."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "pm",
                                                "lse", "plen", "kpos")]
                + [(n, ctypes.c_longlong) for n in (
                    "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh",
                    "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S_q", "S_k", "q_offset", "Hq", "Hkv", "D",
                    "dtype", "mode")]
                + [("sm_scale", ctypes.c_float)])


class FlashLaunch(ctypes.Structure):
    """Mirror of `FlashLaunch` in csrc/flash_prefill.cuh: the kernel's
    arguments and the tile or variant the dispatch reads (0: defaults)."""

    _fields_ = [("p", FlashParams)] + [(n, ctypes.c_int) for n in (
        "rows", "keys", "variant")]


# The limit a bf16 K1 output is held to against its plain version in
# float32, per element: BF16_ULPS ulps of |ref| (the output's own rounding),
# plus BF16_P_ROUNDING * (sum_j p_j |v_j|) / l (the tensor cores take P
# rounded to bf16, a relative step of 2^-9 per probability, as the TPU
# kernel's p.astype(v.dtype) does; 2x headroom), plus BF16_FLOOR.
BF16_ULPS = 2
BF16_P_ROUNDING = 2.0 ** -8
BF16_FLOOR = 1e-5


def bf16_output_limit(ref: torch.Tensor, ref_abs: torch.Tensor
                      ) -> torch.Tensor:
    """Per-element limit for a bf16 K1 output: `ref` is the plain version's
    output on float32 copies of the inputs, `ref_abs` the same with v
    replaced by |v| (so it is sum_j p_j |v_j| / l)."""
    ref = ref.float()
    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8-bit significand
    return BF16_ULPS * ulp + BF16_P_ROUNDING * ref_abs.float() + BF16_FLOOR


def bf16_limit_share(out: torch.Tensor, ref: torch.Tensor,
                     ref_abs: torch.Tensor) -> float:
    """Largest share of its `bf16_output_limit` that any element of `out`
    uses; the output passes at <= 1."""
    err = (out.float() - ref.float()).abs()
    return float((err / bf16_output_limit(ref, ref_abs)).max())


class InstanceInfo(ctypes.Structure):
    """Mirror of `FlashInstanceInfo` in csrc/flash_prefill.cuh."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "bf16", "head_dim", "regs", "local_bytes", "static_smem",
        "dynamic_smem", "threads", "rows", "keys", "variant")]


def default_tile(mode: int, d: int) -> Tuple[int, int]:
    """(query rows, keys) of `mode`'s tensor-core tile at head_dim `d` when
    a call names none (tc::DefaultTile)."""
    return (64 if d > 128 else 128,
            64 if mode == _POSITIONED or d > 128 else 128)


def built_tiles(mode: int, d: int) -> Tuple[Tuple[int, int], ...]:
    """Every (rows, keys) tile the build holds for `mode` at head_dim `d`
    (tc::tile_built): at head_dim 64 and 128 every tile of 64 or 128 rows
    by 64 or 128 keys but mode (d)'s 128 x 128 (it spills), elsewhere the
    default alone."""
    if d in _TILE_HEAD_DIMS:
        return tuple((r, k) for r in _TILE_SIDES for k in _TILE_SIDES
                     if (mode, r, k) != (_POSITIONED, 128, 128))
    return (default_tile(mode, d),)


def variant_name(variant: int) -> str:
    """The flags of a variant bit mask, JAX's names joined by "+"; ""
    for the default kernel."""
    return "+".join(name for name, flag in VARIANT_FLAGS if variant & flag)


def kernel_instances() -> list:
    """What the build made of each K1 instance: the defaults (3 modes x 2
    routes x 5 head dims), the non-default tensor-core tiles
    (`built_tiles`) and mode (a)'s variants (7 combinations x 5 head dims
    in bf16, and exp_bf16 in float32): registers, local memory (spill)
    bytes, static and dynamic shared memory, threads per block, the tile
    (rows, keys) and the variant. Builds the library if needed; needs a
    CUDA device."""
    lib = _build.load_library().lib
    entries = {
        "default": (lib.flash_prefill_instance_info, [ctypes.c_int] * 2),
        "tile": (lib.flash_prefill_tile_info, [ctypes.c_int] * 4),
        "variant": (lib.flash_prefill_variant_info, [ctypes.c_int] * 3)}
    for fn, args in entries.values():
        fn.argtypes = args + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    calls = [("default", (mode, index), mode) for mode in _MODE_NAMES
             for index in range(2 * len(_HEAD_DIMS))]
    calls += [("tile", (mode, d, r, k), mode) for mode in _MODE_NAMES
              for d in _TILE_HEAD_DIMS for r, k in built_tiles(mode, d)
              if (r, k) != default_tile(mode, d)]
    calls += [("variant", (v, d, bf16), _CAUSAL) for v in range(1, 8)
              for d in _HEAD_DIMS for bf16 in (1, 0)
              if bf16 or v == _EXP_BF16]
    rows = []
    for entry, args, mode in calls:
        info = InstanceInfo()
        err = entries[entry][0](*args, ctypes.addressof(info))
        if err:
            raise RuntimeError(f"flash_prefill_{entry}_info{args} failed: "
                               f"CUDA error {err}")
        rows.append({"mode": _MODE_NAMES[mode],
                     "dtype": "bfloat16" if info.bf16 else "float32",
                     **{n: getattr(info, n) for n, _ in
                        InstanceInfo._fields_ if n not in ("bf16",
                                                           "variant")},
                     "variant": variant_name(info.variant)})
    return rows


def resolve_tile(mode: int, d: int, s_q: int, s_k: int,
                 block_q: Optional[int] = None,
                 block_k: Optional[int] = None) -> Tuple[int, int]:
    """The (rows, keys) tile a K1 call of `mode` at head_dim `d` over
    `s_q` query rows and `s_k` keys runs: the default tile where the
    call names none, else `block_q` / `block_k` clamped to the next power
    of two of the sequence (at least 8), as JAX clamps. Raises ValueError
    for a size that is not a power of two (as JAX does) and for a tile
    the build lacks, naming the tiles built for that mode and head_dim."""
    for name, n in (("block_q", block_q), ("block_k", block_k)):
        if n is not None and (n < 1 or n & (n - 1)):
            raise ValueError(f"flash prefill: {name}={n}: block sizes must "
                             f"be powers of two")
    rows, keys = default_tile(mode, d)
    if block_q is not None:
        rows = min(block_q, max(8, 1 << (s_q - 1).bit_length()))
    if block_k is not None:
        keys = min(block_k, max(8, 1 << (s_k - 1).bit_length()))
    tiles = built_tiles(mode, d)
    if (rows, keys) not in tiles:
        raise ValueError(f"flash prefill: no {rows} x {keys} tile (block_q "
                         f"x block_k) is built for mode "
                         f"{_MODE_NAMES[mode]} at head_dim {d}; built: "
                         f"{list(tiles)}")
    return rows, keys


def _resolve_variant(q, k, tile, fold_gqa, exp_bf16, stats_via_mxu) -> int:
    """Mode (a)'s variant bit mask; raises ValueError for a variant off
    the default tile, or a fold whose group outgrows the tile's rows."""
    variant = ((_FOLD if fold_gqa else 0) | (_EXP_BF16 if exp_bf16 else 0)
               | (_STATS_MXU if stats_via_mxu else 0))
    d = q.shape[3]
    if variant and tile != default_tile(_CAUSAL, d):
        raise ValueError(f"flash prefill: {variant_name(variant)} is built "
                         f"at the default tile {default_tile(_CAUSAL, d)} "
                         f"only, not at {tile}")
    n_rep = q.shape[2] // max(k.shape[2], 1)
    if variant & _FOLD and n_rep > tile[0]:
        raise ValueError(f"flash prefill: fold_gqa packs the {n_rep} query "
                         f"heads of a kv head into one block's {tile[0]} "
                         f"rows, which must hold one position of each")
    return variant


def exp_block_keys(dtype: torch.dtype, tile: Tuple[int, int]) -> int:
    """Keys per block of the running maximum against which the exp_bf16
    route rounds s - m (the plain version's `exp_block_k`): the tile's
    keys on the bf16 route, the scalar kernel's 16-key sub-tile
    (csrc/flash_prefill_scalar.cuh, SUB) on the float32 one."""
    return tile[1] if dtype == torch.bfloat16 else _SCALAR_SUB_KEYS


def _count(wrapper, q: torch.Tensor, tile: Tuple[int, int],
           variant: int = 0) -> None:
    """One launch on `wrapper`'s counters: `launches`, `tile_launches` by
    the instance that ran (`tile` on the tensor-core route, "float32" on
    the scalar one) and, for a variant, `variant_launches` by its name
    (the float32 route runs exp_bf16 alone)."""
    wrapper.launches += 1
    bf16 = q.dtype == torch.bfloat16
    key = tile if bf16 else "float32"
    wrapper.tile_launches[key] = wrapper.tile_launches.get(key, 0) + 1
    name = variant_name(variant if bf16 else variant & _EXP_BF16)
    if name:
        wrapper.variant_launches[name] = (
            wrapper.variant_launches.get(name, 0) + 1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int = 0, mode: int = _CAUSAL) -> None:
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
    if q_offset < 0 or (mode == _CAUSAL and q_offset + s > k.shape[1]):
        raise ValueError(f"flash prefill: rows {q_offset}..{q_offset + s} "
                         f"lie outside the {k.shape[1]}-row key buffer")
    if hq % k.shape[2]:
        raise ValueError("flash prefill: Hq must be a multiple of Hkv")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash prefill: head_dim {d} not in {_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash prefill: the head_dim axis must be "
                         "contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(s % 8 for s in _strides(t)):
                raise ValueError(
                    f"flash prefill: the bf16 kernel reads {name} by TMA, "
                    f"which needs a 16-byte aligned base and strides that "
                    f"are multiples of 8 elements; got base offset "
                    f"{t.data_ptr() % 16} B and strides {t.stride()}")


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """Element strides of t's batch, row and head axes. An axis of size 1
    is never stepped, and PyTorch leaves its stride free, so it takes the
    stride a contiguous tensor of t's shape would have."""
    return tuple(t.stride(i) if t.shape[i] != 1 else math.prod(t.shape[i + 1:])
                 for i in range(3))


def _row_lengths(lens: Union[int, torch.Tensor], b: int,
                 device) -> torch.Tensor:
    """Per-row lengths as int32 [B] on `device`: a host int is filled on
    the device (no host-to-device copy that would wait for queued work)."""
    if torch.is_tensor(lens):
        return lens.to(device=device, dtype=torch.int32).expand(b) \
            .contiguous()
    return torch.full((b,), int(lens), dtype=torch.int32, device=device)


def _launch(q, k, v, q_offset: int, plen: torch.Tensor, mode: int = _CAUSAL,
            kpos: Optional[torch.Tensor] = None, with_lse: bool = False,
            tile: Optional[Tuple[int, int]] = None, variant: int = 0):
    """Checks, allocates and launches K1. plen: int32 [B] on q's device;
    tile: the (rows, keys) from `resolve_tile` (None: the default);
    variant: mode (a)'s bit mask. Returns (out, lse [B, Hq, S_q] or None,
    prompt mass [B, Hq, S_q]), the statistics per head."""
    _check(q, k, v, q_offset, mode)
    b, s_q, hq, d = q.shape
    # The float32 route has one layout and, of the variants, exp_bf16.
    bf16 = q.dtype == torch.bfloat16
    rows, keys = ((0, 0) if not bf16 or tile in (None,
                                                 default_tile(mode, d))
                  else tile)
    variant = variant if bf16 else variant & _EXP_BF16
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    pm = torch.empty((b, hq, s_q), dtype=torch.float32, device=q.device)
    lse = torch.empty_like(pm) if with_lse else None
    if kpos is not None:
        if (kpos.dtype != torch.int32 or kpos.shape != k.shape[:2]
                or not kpos.is_contiguous() or kpos.device != q.device):
            raise ValueError("flash prefill: key positions must be a "
                             "contiguous int32 [B, S_k] tensor on q's device")
    params = FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
        pm=pm.data_ptr(), lse=lse.data_ptr() if with_lse else None,
        plen=plen.data_ptr(), kpos=None if kpos is None else kpos.data_ptr(),
        **{f"{n}_s{a}": s for n, x in (("q", q), ("k", k), ("v", v),
                                        ("o", out))
           for a, s in zip("bsh", _strides(x))},
        B=b, S_q=s_q, S_k=k.shape[1], q_offset=q_offset, Hq=hq,
        Hkv=k.shape[2], D=d, dtype=_build.dtype_code(q.dtype), mode=mode,
        sm_scale=1.0 / d ** 0.5)
    _build.launch("flash_prefill_launch",
                  FlashLaunch(p=params, rows=rows, keys=keys, variant=variant),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse, pm


def _prompt_len_rows(q, prompt_len: int, prompt_lens) -> torch.Tensor:
    if prompt_lens is None:
        return _row_lengths(prompt_len, q.shape[0], q.device)
    return torch.clamp(prompt_lens.to(device=q.device, dtype=torch.int32),
                       max=prompt_len).contiguous()


def flash_prefill_with_prompt_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_len: int,
    prompt_lens: Optional[torch.Tensor] = None,
    group=None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    fold_gqa: Optional[bool] = None,
    exp_bf16: bool = False,
    stats_via_mxu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mode (a): causal attention + prompt attention mass, the contract of
    `prefill_attention_with_prompt_mass`.

    q: [B, S, H_q, D]; k, v: [B, S, H_kv, D]; prompt_lens: optional [B]
    per-row prompt lengths <= prompt_len. Returns (out [B, S, H_q, D] in q's
    dtype, prompt_mass [B, S] float32 averaged over heads: the kernel's
    per-head mass, gathered over `group` first under tensor parallelism,
    `head_mean`).

    block_q / block_k: the tile (`resolve_tile`). JAX's variants, each a
    hand-written instance of the bf16 route at the default tile:
    fold_gqa=True packs a kv head's n_rep query heads into one block's
    rows, so each K/V tile is staged once for the group (None, the
    default, and False: one query head a block; JAX's default is True);
    exp_bf16 rounds s - max to bf16 and exponentiates on bf16 lanes (this
    changes the function: the plain version rounds alike, against the
    same running maximum, `exp_block_keys`); stats_via_mxu takes l and
    the prompt mass from a tensor-core product of P with [ones | prompt
    indicator]. The float32 route computes the same function with its one
    layout: it applies exp_bf16's rounding and has no fold_gqa or
    stats_via_mxu layout, which leave the function as it is.
    """
    tile = resolve_tile(_CAUSAL, q.shape[3], q.shape[1], k.shape[1],
                        block_q, block_k)
    variant = _resolve_variant(q, k, tile, fold_gqa, exp_bf16,
                               stats_via_mxu)
    if q.device.type == "cpu":
        return prefill_attention_with_prompt_mass(q, k, v, prompt_len,
                                                  prompt_lens=prompt_lens,
                                                  group=group,
                                                  exp_bf16=exp_bf16,
                                                  exp_block_k=exp_block_keys(
                                                      q.dtype, tile))
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash prefill: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    out, _, pm = _launch(q, k, v, 0, _prompt_len_rows(q, prompt_len,
                                                      prompt_lens),
                         tile=tile, variant=variant)
    _count(flash_prefill_with_prompt_mass, q, tile, variant)
    return out, head_mean(pm, group)


def flash_chunk_attention_with_prompt_mass(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    q_offset: int,
    prompt_len: int,
    prompt_lens: Optional[torch.Tensor] = None,
    group=None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mode (b): one prefill chunk over the position-ordered KV buffer, the
    contract of `chunk_attention_with_prompt_mass`.

    q: [B, c, H_q, D] at positions q_offset .. q_offset + c - 1 (a host
    int: the chunk loop runs on the host); k_buf, v_buf: [B, S, H_kv, D]
    with the chunk written, q_offset + c <= S. Returns (out [B, c, H_q, D]
    in q's dtype, prompt_mass [B, c] float32; `group` as in mode (a)).
    block_q / block_k: the tile (`resolve_tile`, over c rows and S keys).
    """
    q_offset = int(q_offset)
    tile = resolve_tile(_CAUSAL, q.shape[3], q.shape[1], k_buf.shape[1],
                        block_q, block_k)
    if q.device.type == "cpu":
        return chunk_attention_with_prompt_mass(q, k_buf, v_buf, q_offset,
                                                prompt_len,
                                                prompt_lens=prompt_lens,
                                                group=group)
    out, _, pm = _launch(q, k_buf, v_buf, q_offset,
                         _prompt_len_rows(q, prompt_len, prompt_lens),
                         tile=tile)
    _count(flash_chunk_attention_with_prompt_mass, q, tile)
    return out, head_mean(pm, group)


# ---------------------------------------------------------------------------
# Partials with the log-sum-exp output: modes (c), (d) and the diagonal pair
# ---------------------------------------------------------------------------

def _attention_with_lse(q, k, v, visible, is_prompt) -> Partial:
    """Dense partial: visible [B, S_q or 1, S_k] and is_prompt [B, 1, S_k]
    bool. Returns (o in q's dtype, lse, pm [B, Hq, S_q] float32 per head);
    a row with no visible key gets o = 0, pm = 0 and lse = -inf.
    Probabilities stay float32 for the value product, as in the kernel."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    q5 = q.reshape(b, sq, hkv, hq // hkv, d)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q5.float(), k.float()) * scale
    logits = torch.where(visible[:, None, None], logits,
                         torch.full((), -torch.inf, device=q.device))
    lse = torch.logsumexp(logits, dim=-1)                  # [B, h, r, S_q]
    shift = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(logits - shift[..., None])               # masked: 0
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    pm = torch.where(is_prompt[:, None, None], p,
                     torch.zeros((), device=q.device)).sum(dim=-1)
    return (out.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq),
            pm.reshape(b, hq, sq))


def pair_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         plen_local: Union[int, torch.Tensor],
                         causal: bool) -> Partial:
    """The plain version of `flash_pair_attention`: q [B, S_q, H_q, D] over
    one key block k, v [B, S_k, H_kv, D]; causal=True is the diagonal pair
    (q and k the same block, S_q = S_k), False full attention. plen_local:
    the prompt length in the key block's coordinates, a host int or [B]."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    cols = torch.arange(sk, device=q.device)
    if causal:
        visible = (cols[None, :] <= torch.arange(sq, device=q.device)[:, None]
                   )[None]
    else:
        visible = torch.ones((1, 1, sk), dtype=torch.bool, device=q.device)
    plen = _row_lengths(plen_local, b, q.device)
    return _attention_with_lse(q, k, v, visible,
                               (cols[None, :] < plen[:, None])[:, None])


def positioned_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_pos: torch.Tensor,
                               q_offset: int, prompt_len: int) -> Partial:
    """The plain version of `flash_positioned_attention`: key j is visible
    to query row i iff k_pos[j] <= q_offset + i, a prompt column iff
    k_pos[j] < prompt_len (invalid slots hold POS_SENTINEL)."""
    q_pos = int(q_offset) + torch.arange(q.shape[1], device=q.device)
    visible = k_pos[:, None, :] <= q_pos[None, :, None]
    return _attention_with_lse(q, k, v, visible,
                               (k_pos < prompt_len)[:, None])


def flash_diagonal_pair_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  plen_local: Union[int, torch.Tensor],
                                  block_q: Optional[int] = None,
                                  block_k: Optional[int] = None) -> Partial:
    """The diagonal pair: mode (a) with the lse output over the block's own
    keys, with its local prompt length (see `flash_pair_attention`)."""
    tile = resolve_tile(_CAUSAL, q.shape[3], q.shape[1], k.shape[1],
                        block_q, block_k)
    if q.device.type == "cpu":
        return pair_attention_plain(q, k, v, plen_local, causal=True)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"diagonal pair: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be one block")
    result = _launch(q, k, v, 0, _row_lengths(plen_local, q.shape[0],
                                              q.device), with_lse=True,
                     tile=tile)
    _count(flash_diagonal_pair_attention, q, tile)
    return result


def flash_full_pair_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              plen_local: Union[int, torch.Tensor],
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None) -> Partial:
    """Mode (c): every query sees every key of the block (see
    `flash_pair_attention`)."""
    tile = resolve_tile(_FULL, q.shape[3], q.shape[1], k.shape[1],
                        block_q, block_k)
    if q.device.type == "cpu":
        return pair_attention_plain(q, k, v, plen_local, causal=False)
    result = _launch(q, k, v, 0, _row_lengths(plen_local, q.shape[0],
                                              q.device), mode=_FULL,
                     with_lse=True, tile=tile)
    _count(flash_full_pair_attention, q, tile)
    return result


def flash_pair_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         plen_local: Union[int, torch.Tensor],
                         causal: bool, block_q: Optional[int] = None,
                         block_k: Optional[int] = None) -> Partial:
    """One (query block, key block) pair of blockwise / ring attention.

    q: [B, S_q, H_q, D]; k, v: [B, S_k, H_kv, D], one key block;
    plen_local: the prompt length in the key block's coordinates,
    clip(prompt_len - k_offset, 0, S_k), a host int or [B]. causal=True is
    the diagonal pair (S_q = S_k), False a key block that precedes every
    query. Returns (o [B, S_q, H_q, D] normalized, lse [B, H_q, S_q],
    pm [B, H_q, S_q] per head) for `merge_attention_partials`; a row with
    no visible key has o = 0, pm = 0 and lse = -inf. block_q / block_k:
    the tile (`resolve_tile`; the diagonal pair's of mode (a), the full
    pair's of mode (c)).
    """
    if causal:
        return flash_diagonal_pair_attention(q, k, v, plen_local,
                                             block_q=block_q,
                                             block_k=block_k)
    return flash_full_pair_attention(q, k, v, plen_local, block_q=block_q,
                                     block_k=block_k)


def flash_positioned_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_pos: torch.Tensor,
                               q_offset: int, prompt_len: int,
                               block_q: Optional[int] = None,
                               block_k: Optional[int] = None) -> Partial:
    """Mode (d): chunk queries over positioned key slots.

    q: [B, c, H_q, D] at global positions q_offset .. q_offset + c - 1 (a
    host int); k, v: [B, N, H_kv, D] dequantized pool slots; k_pos: [B, N]
    int32 global positions (invalid slots at POS_SENTINEL); key j is
    visible to row i iff k_pos[j] <= q_offset + i and is a prompt column
    iff k_pos[j] < prompt_len. Returns (o, lse, pm) as
    `flash_pair_attention` does. block_q / block_k: the tile
    (`resolve_tile`, over c rows and N slots).
    """
    q_offset = int(q_offset)
    tile = resolve_tile(_POSITIONED, q.shape[3], q.shape[1], k.shape[1],
                        block_q, block_k)
    if q.device.type == "cpu":
        return positioned_attention_plain(q, k, v, k_pos, q_offset,
                                          prompt_len)
    result = _launch(q, k, v, q_offset,
                     _row_lengths(prompt_len, q.shape[0], q.device),
                     mode=_POSITIONED,
                     kpos=k_pos.to(torch.int32).contiguous(), with_lse=True,
                     tile=tile)
    _count(flash_positioned_attention, q, tile)
    return result


def merge_attention_partials(parts: Sequence[Partial]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact log-sum-exp merge of normalized partials over disjoint key
    sets: parts of (o [B, S, Hq, D], lse [B, Hq, S], pm [B, Hq, S] or
    None), merged in the order given. Returns (out [B, S, Hq, D] float32,
    pm [B, Hq, S] per head, None where the parts carry none). A part
    whose lse is -inf weighs 0; rows where every part is -inf give 0."""
    lse_all = torch.stack([p[1] for p in parts])          # [T, B, Hq, S]
    m = lse_all.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse_all - m[None])
    w_sum = torch.clamp(w.sum(dim=0), min=1e-30)
    o_all = torch.stack([p[0].float() for p in parts])
    w_q = w.movedim(3, 2)                                 # [T, B, S, Hq]
    out = ((o_all * w_q[..., None]).sum(dim=0)
           / w_sum.movedim(2, 1)[..., None])              # [B, S, Hq, D]
    if parts[0][2] is None:
        return out, None
    pm = (torch.stack([p[2] for p in parts]) * w).sum(dim=0) / w_sum
    return out, pm


def flash_compressed_prefix_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pos_pool: torch.Tensor,
    valid_pool: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    q_offset: int,
    prompt_len: int,
    group=None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    pool_block_q: Optional[int] = None,
    pool_block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk attention over {compressed pools} ++ {own chunk}, flash form:
    mode (d) over the dequantized pools, the diagonal pair over the chunk's
    own K/V, merged by log-sum-exp. Each partial's o comes in q's dtype and
    merges in float32, then casts back, as in the reference. The dense form
    is `ops.attention.positioned_attention_with_prompt_mass` over the
    concatenated set.

    q: [B, c, Hq, D] at q_offset (host int); k_pool, v_pool: [B, N, Hkv, D]
    in q's dtype; pos_pool [B, N] int32, valid_pool [B, N] bool; k_chunk,
    v_chunk: [B, c, Hkv, D]. Returns (out [B, c, Hq, D], prompt_mass [B, c];
    `group` as in mode (a)). block_q / block_k: the diagonal pair's tile,
    pool_block_q / pool_block_k mode (d)'s (`resolve_tile`).
    """
    b, c = q.shape[:2]
    q_offset = int(q_offset)
    kpos = torch.where(valid_pool, pos_pool.to(torch.int32),
                       torch.full((), POS_SENTINEL, dtype=torch.int32,
                                  device=pos_pool.device))
    part_pool = flash_positioned_attention(q, k_pool, v_pool, kpos, q_offset,
                                           prompt_len, block_q=pool_block_q,
                                           block_k=pool_block_k)
    plen_local = min(max(prompt_len - q_offset, 0), c)
    part_self = flash_pair_attention(q, k_chunk, v_chunk, plen_local,
                                     causal=True, block_q=block_q,
                                     block_k=block_k)
    out, pm = merge_attention_partials([part_pool, part_self])
    return out.to(q.dtype), head_mean(pm, group)


for _wrapper in (flash_prefill_with_prompt_mass,
                 flash_chunk_attention_with_prompt_mass,
                 flash_diagonal_pair_attention, flash_full_pair_attention,
                 flash_positioned_attention):
    _wrapper.launches = 0
    _wrapper.tile_launches = {}
    _wrapper.variant_launches = {}
del _wrapper
