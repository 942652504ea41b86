"""Dense attention references with the prompt-mass side channel (PyTorch).

Port of the dense functions of the JAX package's `ops/attention.py`. They
are the plain versions the CUDA kernels are checked against (flash prefill:
`prefill_attention_with_prompt_mass`, and `chunk_attention_with_prompt_mass`
for its chunked mode; fused decode: dequantize, then
`attention_over_tokens`), the uncompressed arm's decode attention, and
`positioned_attention_with_prompt_mass`, the compressed-prefix chunked
prefill's dense arm (`use_flash=False`). `query_attention_mass` and
`window_attention_mass` give the observation-window mass of query-guided
importance (`importance_source` "query" / "both"); they are plain code in
the reference too, with no kernel behind them.
Logits and accumulation are float32 as in the reference: bf16 operands are
widened before the products, and probabilities are cast to the value dtype
before the value product, like the reference's bf16 einsums with
`preferred_element_type=float32`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, H_kv, D] → [B, S, H_kv * n_rep, D] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def prefill_attention_with_prompt_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_len: int,
    causal: bool = True,
    prompt_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense causal attention + prompt attention mass.

    q: [B, S, H_q, D]; k, v: [B, S, H_kv, D]; prompt_lens: optional [B]
    per-row prompt lengths <= prompt_len. Returns (out [B, S, H_q, D] in
    q's dtype, prompt_mass [B, S] float32 = mean over heads of the softmax
    mass on key columns < the row's prompt length).
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
    attn = torch.softmax(logits, dim=-1)
    prompt_probs = attn[:, :, :, :prompt_len]
    if prompt_lens is not None:
        col = torch.arange(prompt_probs.shape[-1], device=q.device)
        prompt_probs = torch.where(
            col[None, None, None, :] < prompt_lens[:, None, None, None],
            prompt_probs, torch.zeros((), device=q.device))
    prompt_mass = prompt_probs.mean(dim=1).sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v.float())
    return out.to(q.dtype), prompt_mass


def attention_over_tokens(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_positions: torch.Tensor,
    k_valid: torch.Tensor,
    q_positions: torch.Tensor,
) -> torch.Tensor:
    """Attention of queries over an arbitrary (gathered/compressed) token set.

    Key j participates for query i iff it is a live slot and
    k_positions[j] <= q_positions[i]. q: [B, Sq, H_q, D]; k, v:
    [B, N, H_kv, D]; k_positions: [B, N] int; k_valid: [B, N] bool;
    q_positions: [B, Sq]. Rows with no valid key give zeros.
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
    return out.reshape(b, sq, hq, d).to(q.dtype)


def chunk_attention_with_prompt_mass(
    q: torch.Tensor,
    k_buf: torch.Tensor,
    v_buf: torch.Tensor,
    q_offset: int,
    prompt_len: int,
    prompt_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectangular causal attention of one prefill chunk over the KV buffer.

    q: [B, c, H_q, D], the chunk's queries at positions q_offset ..
    q_offset + c - 1; k_buf, v_buf: [B, S, H_kv, D] position-ordered
    buffers with this chunk already written (rows past the fill hold later
    positions, so causality hides them); prompt_lens: optional [B] per-row
    prompt lengths <= prompt_len. Returns (out [B, c, H_q, D] in q's dtype,
    prompt_mass [B, c] float32), as `prefill_attention_with_prompt_mass`
    gives for the same rows of the whole sequence.
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
    prompt_mass = prompt_probs.sum(dim=-1).mean(dim=(1, 2))   # [B, c]
    out = torch.einsum("bhrqk,bkhd->bqhrd", attn.to(v_buf.dtype).float(),
                       v_buf.float())
    return out.reshape(b, c, hq, d).to(q.dtype), prompt_mass


def query_attention_mass(
    q: torch.Tensor,
    k: torch.Tensor,
    window: int,
    lengths: Optional[torch.Tensor] = None,
    pool: int = 0,
) -> torch.Tensor:
    """Observation-window mass: the attention each key receives from the
    last `window` prefill queries (importance_source "query" / "both").

    q: [B, S, H_q, D] and k: [B, S, H_kv, D], both RoPE'd; lengths:
    optional [B] true lengths of right-padded rows, whose windows then end
    at their true lengths (rows before position 0, when a length is below
    the window, are masked out); pool: max-pool width over key positions
    (0 or 1: none). Returns [B, S] float32: per key column, the mean over
    heads of the softmax summed over the window rows.
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
    return window_attention_mass(q_w, q_pos, row_ok, k, key_ok, pool=pool)


def window_attention_mass(
    q_w: torch.Tensor,
    q_pos: torch.Tensor,
    row_ok: torch.Tensor,
    k: torch.Tensor,
    key_ok: torch.Tensor,
    pool: int = 0,
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
    mass = attn.mean(dim=(1, 2)).sum(dim=1)                     # [B, S]
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of chunk queries over a positioned token set, with the
    prompt-mass side channel: the dense form of the compressed-prefix
    chunked prefill (pool slots ++ the chunk's own K/V).

    Key j is visible to query i iff it is valid and k_positions[j] <=
    q_positions[i]; it is a prompt column iff it is valid and k_positions[j]
    < prompt_len. q: [B, c, H_q, D]; k, v: [B, N, H_kv, D]; k_positions:
    [B, N] int; k_valid: [B, N] bool; q_positions: [B, c]. Returns (out
    [B, c, H_q, D] in q's dtype, prompt_mass [B, c] float32, head-averaged);
    a row that sees no key gets zeros in both. (The reference's per-row
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
    prompt_mass = pmass.sum(dim=-1).mean(dim=(1, 2))          # [B, c]
    out = torch.einsum("bhrqk,bkhd->bqhrd", attn.to(v.dtype).float(),
                       v.float())
    any_valid = mask.any(dim=-1)                              # [B, c]
    out = torch.where(any_valid[:, :, None, None, None], out,
                      torch.zeros((), device=q.device))
    return (out.reshape(b, sq, hq, d).to(q.dtype),
            torch.where(any_valid, prompt_mass,
                        torch.zeros((), device=q.device)))
