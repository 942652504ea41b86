"""Dense attention references with the prompt-mass side channel (PyTorch).

Port of the dense functions of the JAX package's `ops/attention.py`. They
are the plain versions the CUDA kernels are checked against (flash prefill:
`prefill_attention_with_prompt_mass`, and `chunk_attention_with_prompt_mass`
for its chunked mode; fused decode: dequantize, then
`attention_over_tokens`), the uncompressed arm's decode attention, and
`positioned_attention_with_prompt_mass`, the compressed-prefix chunked
prefill's dense arm (`use_flash=False`).
Logits and accumulation are float32 as in the reference: bf16 operands are
widened before the products, and probabilities are cast to the value dtype
before the value product, like the reference's bf16 einsums with
`preferred_element_type=float32`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
