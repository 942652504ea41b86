"""Dense attention references with the prompt-mass side channel (PyTorch).

Port of the dense functions of the JAX package's `ops/attention.py`. They
are the plain versions the CUDA kernels are checked against (flash prefill:
`prefill_attention_with_prompt_mass`, and `chunk_attention_with_prompt_mass`
for its chunked mode; fused decode: dequantize, then
`attention_over_tokens`), the uncompressed arm's decode attention, and
`positioned_attention_with_prompt_mass`, the compressed-prefix chunked
prefill's dense arm (`use_flash=False`). `query_attention_mass` and
`window_attention_mass` give the observation-window mass of query-guided
importance (`importance_source` "query" / "both"), and
`sharded_window_attention_mass` the same mass with the keys sharded over
a process group (sequence-parallel prefill); they are plain code in the
reference too, with no kernel behind them.
Under tensor parallelism each rank holds a block of the heads: the
functions that give a head-averaged mass take the model axis's `group`,
and gather the per-head masses over it before the mean (`head_mean`), so
every rank averages the same [B, H, ...] tensor.
Logits and accumulation are float32 as in the reference: bf16 operands are
widened before the products, and probabilities are cast to the value dtype
before the value product, like the reference's bf16 einsums with
`preferred_element_type=float32`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import comm

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def ex2_bf16(x: torch.Tensor) -> torch.Tensor:
    """exp2 of bf16 values x as the H100's `ex2.approx.ftz.bf16x2` gives
    them, in float32: exp2 truncated to bf16, 1 where |x| < 2^-23, and 0
    below -126, where the result would be subnormal
    (scripts/torch_ex2_bf16_probe.py holds this to the card bit for bit on
    every bf16 input)."""
    x = x.float()
    e = torch.exp2(x).view(torch.int32).bitwise_and(-65536).view(torch.float32)
    return torch.where(x.abs() < 2.0 ** -23, 1.0,
                       torch.where(x < -126, 0.0, e))


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, H_kv, D] → [B, S, H_kv * n_rep, D] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def head_mean(per_head: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the head axis (dim 1) of a per-head mass [B, H, ...].
    With `group` (tensor parallelism's model axis, each rank holding a
    contiguous block of the heads in rank order) every rank's heads are
    gathered first: each rank then takes the one-rank mean over all
    heads, bit for bit the same on every rank (an all-reduce of partial
    means would reorder the float32 sum)."""
    if group is not None:
        per_head = comm.all_gather(per_head, 1, group)
    return per_head.mean(dim=1)


def prefill_attention_with_prompt_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_len: int,
    causal: bool = True,
    prompt_lens: Optional[torch.Tensor] = None,
    group=None,
    exp_bf16: bool = False,
    exp_block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense causal attention + prompt attention mass.

    q: [B, S, H_q, D]; k, v: [B, S, H_kv, D]; prompt_lens: optional [B]
    per-row prompt lengths <= prompt_len. Returns (out [B, S, H_q, D] in
    q's dtype, prompt_mass [B, S] float32 = mean over heads of the softmax
    mass on key columns < the row's prompt length; with `group`, over the
    heads of every rank of the group, `head_mean`).

    exp_bf16: the probabilities of the flash kernel's exp_bf16 variant (JAX
    `flash_prefill_with_prompt_mass(exp_bf16=True)`): the base-2 logits
    less a running maximum rounded to bf16 and exponentiated on bf16 lanes
    as the card does it (`ex2_bf16`); each is rescaled in float32 from its
    running maximum to the row's, and the softmax divides them by their
    sum. The running maximum is the kernel's: over the keys up to the end
    of each `exp_block_k`-key block from key 0 (None: one block, the row's
    maximum).
    """
    b, s, hq, d = q.shape
    n_rep = hq // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        visible = pos[None, :] <= pos[:, None]
        logits = torch.where(visible[None, None], logits,
                             torch.full((), NEG_INF, device=q.device))
    if exp_bf16:
        s2 = logits * LOG2E
        s_k = s2.shape[-1]
        blk = s_k if exp_block_k is None else exp_block_k
        nb = -(-s_k // blk)
        m_blk = F.pad(s2, (0, nb * blk - s_k), value=NEG_INF).unflatten(
            -1, (nb, blk)).amax(dim=-1).cummax(dim=-1).values
        m_run = m_blk.repeat_interleave(blk, dim=-1)[..., :s_k]
        p = ex2_bf16((s2 - m_run).to(torch.bfloat16)) * torch.exp2(
            m_run - m_blk[..., -1:])
        attn = p / p.sum(dim=-1, keepdim=True)
    else:
        attn = torch.softmax(logits, dim=-1)
    prompt_probs = attn[:, :, :, :prompt_len]
    if prompt_lens is not None:
        col = torch.arange(prompt_probs.shape[-1], device=q.device)
        prompt_probs = torch.where(
            col[None, None, None, :] < prompt_lens[:, None, None, None],
            prompt_probs, torch.zeros((), device=q.device))
    if group is None:
        prompt_mass = prompt_probs.mean(dim=1).sum(dim=-1)
    else:
        prompt_mass = head_mean(prompt_probs.sum(dim=-1), group)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v.float())
    return out.to(q.dtype), prompt_mass


def attention_over_tokens(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_positions: torch.Tensor,
    k_valid: torch.Tensor,
    q_positions: torch.Tensor,
    return_lse: bool = False,
):
    """Attention of queries over an arbitrary (gathered/compressed) token set.

    Key j participates for query i iff it is a live slot and
    k_positions[j] <= q_positions[i]. q: [B, Sq, H_q, D]; k, v:
    [B, N, H_kv, D]; k_positions: [B, N] int; k_valid: [B, N] bool;
    q_positions: [B, Sq]. Rows with no valid key give zeros. With
    `return_lse`, returns (the output in float32, unrounded; the
    log-sum-exp of the scaled logits [B, H_q, Sq] float32, -inf on rows
    with no valid key): a partial that `merge_attention_partials` merges
    exactly with others over disjoint key sets.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    q5 = q.reshape(b, sq, hkv, n_rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q5.float(), k.float()) * scale
    mask = k_valid[:, None, :] & (k_positions[:, None, :]
                                  <= q_positions[:, :, None])  # [B, Sq, N]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", attn.to(v.dtype).float(),
                       v.float())
    any_valid = mask.any(dim=-1)[:, :, None, None, None]
    out = torch.where(any_valid, out, torch.zeros((), device=q.device))
    if not return_lse:
        return out.reshape(b, sq, hq, d).to(q.dtype)
    lse = torch.where(any_valid[..., 0].permute(0, 2, 3, 1),
                      torch.logsumexp(logits, dim=-1),
                      torch.full((), -torch.inf, device=q.device))
    return out.reshape(b, sq, hq, d), lse.reshape(b, hq, sq)


def chunk_attention_with_prompt_mass(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    q_offset: int,
    prompt_len: int,
    prompt_lens: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectangular causal attention of one prefill chunk over the KV buffer.

    q: [B, c, H_q, D], the chunk's queries at positions q_offset ..
    q_offset + c - 1; k_buf, v_buf: [B, S, H_kv, D] position-ordered
    buffers with this chunk already written (rows past the fill hold later
    positions, so causality hides them); prompt_lens: optional [B] per-row
    prompt lengths <= prompt_len. Returns (out [B, c, H_q, D] in q's dtype,
    prompt_mass [B, c] float32), as `prefill_attention_with_prompt_mass`
    gives for the same rows of the whole sequence (`group`: as there).
    """
    b, c, hq, d = q.shape
    s, hkv = k_buf.shape[1], k_buf.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    q5 = q.reshape(b, c, hkv, n_rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q5.float(),
                          k_buf.float()) * scale
    q_pos = q_offset + torch.arange(c, device=q.device)
    visible = torch.arange(s, device=q.device)[None, :] <= q_pos[:, None]
    logits = torch.where(visible, logits,
                         torch.full((), NEG_INF, device=q.device))
    attn = torch.softmax(logits, dim=-1)                      # [B,h,r,c,S]
    prompt_probs = attn[..., :prompt_len]
    if prompt_lens is not None:
        col = torch.arange(prompt_probs.shape[-1], device=q.device)
        prompt_probs = torch.where(
            col < prompt_lens.to(q.device)[:, None, None, None, None],
            prompt_probs, torch.zeros((), device=q.device))
    if group is None:
        prompt_mass = prompt_probs.sum(dim=-1).mean(dim=(1, 2))  # [B, c]
    else:
        prompt_mass = head_mean(prompt_probs.sum(dim=-1).flatten(1, 2),
                                group)
    out = torch.einsum("bhrqk,bkhd->bqhrd", attn.to(v_buf.dtype).float(),
                       v_buf.float())
    return out.reshape(b, c, hq, d).to(q.dtype), prompt_mass


def query_attention_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    window: int,
    lengths: Optional[torch.Tensor] = None,
    pool: int = 0,
    group=None,
) -> torch.Tensor:
    """Observation-window mass: the attention each key receives from the
    last `window` prefill queries (importance_source "query" / "both").

    q: [B, S, H_q, D] and k: [B, S, H_kv, D], both RoPE'd; lengths:
    optional [B] true lengths of right-padded rows, whose windows then end
    at their true lengths (rows before position 0, when a length is below
    the window, are masked out); pool: max-pool width over key positions
    (0 or 1: none). Returns [B, S] float32: per key column, the mean over
    heads of the softmax summed over the window rows (with `group`, over
    the heads of every rank of the group, `head_mean`).
    """
    b, s = q.shape[:2]
    w = min(window, s)
    if lengths is None:
        q_w = q[:, s - w:]
        q_pos = torch.arange(s - w, s, device=q.device)[None].expand(b, w)
        row_ok = torch.ones((b, w), dtype=torch.bool, device=q.device)
        key_ok = torch.ones((b, s), dtype=torch.bool, device=q.device)
    else:
        idx = lengths[:, None] - w + torch.arange(w, device=q.device)[None]
        row_ok = idx >= 0
        idx = torch.clamp(idx, 0, s - 1)
        q_w = torch.gather(q, 1, idx.long()[:, :, None, None].expand(
            b, w, *q.shape[2:]))
        q_pos = idx
        key_ok = torch.arange(s, device=q.device)[None] < lengths[:, None]
    return window_attention_mass(q_w, q_pos, row_ok, k, key_ok, pool=pool,
                                 group=group)


def window_attention_mass(
    q_w: torch.Tensor,
    q_pos: torch.Tensor,
    row_ok: torch.Tensor,
    k: torch.Tensor,
    key_ok: torch.Tensor,
    pool: int = 0,
    group=None,
) -> torch.Tensor:
    """Core of `query_attention_mass` over an already-gathered window (the
    chunked prefill buffers the window's query rows across chunks and calls
    this at finish).

    q_w: [B, W, H_q, D] window queries at positions q_pos [B, W]; row_ok:
    [B, W] bool, the rows that exist; k: [B, S, H_kv, D] all keys; key_ok:
    [B, S] bool validity; pool: max-pool width over key positions. The
    pool pads as the reference's stride-1 "SAME" window does: (pool - 1)
    // 2 columns below and the rest above (asymmetric for an even width),
    and padding columns are zeroed after it.
    """
    b, w, hq, d = q_w.shape
    s, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    q5 = q_w.reshape(b, w, hkv, hq // hkv, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q5.float(), k.float()) * scale
    mask = key_ok[:, None, :] & (torch.arange(s, device=k.device)[None, None]
                                 <= q_pos[:, :, None])          # [B, W, S]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=k.device))
    attn = torch.softmax(logits, dim=-1)                        # [B,h,r,W,S]
    attn = torch.where(row_ok[:, None, None, :, None], attn,
                       torch.zeros((), device=k.device))
    if group is None:
        mass = attn.mean(dim=(1, 2)).sum(dim=1)                 # [B, S]
    else:
        mass = head_mean(attn.sum(dim=3).flatten(1, 2), group)
    if pool and pool > 1:
        lo = (pool - 1) // 2
        padded = F.pad(mass[:, None], (lo, pool - 1 - lo), value=-torch.inf)
        mass = F.max_pool1d(padded, pool, stride=1)[:, 0]
        mass = torch.where(key_ok, mass, torch.zeros((), device=k.device))
    return mass


def positioned_attention_with_prompt_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_positions: torch.Tensor,
    k_valid: torch.Tensor,
    q_positions: torch.Tensor,
    prompt_len: int,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of chunk queries over a positioned token set, with the
    prompt-mass side channel: the dense form of the compressed-prefix
    chunked prefill (pool slots ++ the chunk's own K/V).

    Key j is visible to query i iff it is valid and k_positions[j] <=
    q_positions[i]; it is a prompt column iff it is valid and k_positions[j]
    < prompt_len. q: [B, c, H_q, D]; k, v: [B, N, H_kv, D]; k_positions:
    [B, N] int; k_valid: [B, N] bool; q_positions: [B, c]. Returns (out
    [B, c, H_q, D] in q's dtype, prompt_mass [B, c] float32, head-averaged,
    over every rank's heads with `group`); a row that sees no key gets
    zeros in both. (The reference's per-row
    `prompt_lens` has no caller and is not ported.)
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    q5 = q.reshape(b, sq, hkv, n_rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q5.float(), k.float()) * scale
    mask = k_valid[:, None, :] & (k_positions[:, None, :]
                                  <= q_positions[:, :, None])  # [B, c, N]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    attn = torch.softmax(logits, dim=-1)                      # [B,h,r,c,N]
    is_prompt = (k_positions < prompt_len) & k_valid          # [B, N]
    pmass = torch.where(is_prompt[:, None, None, None], attn,
                        torch.zeros((), device=q.device))
    if group is None:
        prompt_mass = pmass.sum(dim=-1).mean(dim=(1, 2))      # [B, c]
    else:
        prompt_mass = head_mean(pmass.sum(dim=-1).flatten(1, 2), group)
    out = torch.einsum("bhrqk,bkhd->bqhrd", attn.to(v.dtype).float(),
                       v.float())
    any_valid = mask.any(dim=-1)                              # [B, c]
    out = torch.where(any_valid[:, :, None, None, None], out,
                      torch.zeros((), device=q.device))
    return (out.reshape(b, sq, hq, d).to(q.dtype),
            torch.where(any_valid, prompt_mass,
                        torch.zeros((), device=q.device)))


def sharded_window_attention_mass(
    q_w: torch.Tensor,
    q_pos: torch.Tensor,
    row_ok: torch.Tensor,
    k: torch.Tensor,
    key_pos: torch.Tensor,
    key_ok: torch.Tensor,
    group,
    pool: int = 0,
) -> torch.Tensor:
    """`window_attention_mass` with the key axis sharded over `group`.

    The observation window (the same on every rank) attends over this
    rank's keys with the softmax normalised over all of them: the row max
    is all-reduced with MAX and the denominator with SUM, so the local
    [B, S_loc] mass is the one-device mass's slice up to float association.

    q_w: [B, W, H_q, D] window queries at global positions q_pos [B, W];
    row_ok: [B, W] the rows that exist; k: [B, S_loc, H_kv, D] this rank's
    keys at global positions key_pos [B, S_loc], key_ok their validity.
    pool: the max-pool width over key positions. The pool's window crosses
    rank boundaries exactly: the (pool - 1) // 2 columns below come from
    the left neighbour and the rest from the right one
    (`comm.neighbour_shift`), zeros past the sequence's ends (the mass is
    >= 0, so zeros act as the one-device call's -inf padding); a halo
    wider than S_loc raises ValueError.
    """
    b, w, hq, d = q_w.shape
    s_loc, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    q5 = q_w.reshape(b, w, hkv, hq // hkv, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q5.float(), k.float()) * scale
    mask = key_ok[:, None, :] & (key_pos[:, None, :]
                                 <= q_pos[:, :, None])        # [B, W, S_loc]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=k.device))
    row_max = comm.all_reduce_max(logits.amax(dim=-1), group)  # [B,h,r,W]
    num = torch.where(mask[:, None, None],
                      torch.exp(logits - row_max[..., None]),
                      torch.zeros((), device=k.device))
    denom = comm.all_reduce_sum(num.sum(dim=-1), group)       # [B,h,r,W]
    attn = num / torch.clamp(denom, min=1e-30)[..., None]
    attn = torch.where(row_ok[:, None, None, :, None], attn,
                       torch.zeros((), device=k.device))
    mass = attn.mean(dim=(1, 2)).sum(dim=1)                   # [B, S_loc]
    if pool and pool > 1:
        lo, hi = (pool - 1) // 2, pool // 2
        if max(lo, hi) > s_loc:
            raise ValueError(f"query_mass_pool {pool} needs a halo of at "
                             f"most the {s_loc} tokens a rank holds; "
                             f"shrink the pool or use fewer ranks")
        # Every rank sends both halos (the ends receive zeros), so each
        # issues the same exchanges.
        left = comm.neighbour_shift(mass[:, s_loc - lo:].contiguous(), 1,
                                    group)
        right = comm.neighbour_shift(mass[:, :hi].contiguous(), -1, group)
        padded = torch.cat([left, mass, right], dim=1)
        mass = F.max_pool1d(padded[:, None], pool, stride=1)[:, 0]
        mass = torch.where(key_ok, mass, torch.zeros((), device=k.device))
    return mass
