"""Prompt-guided token importance scoring (PyTorch).

Port of the JAX package's `ops/importance.py` for the prompt-mass source:

    s_i = alpha * Â_P,i * w_l + beta * b_pos(i) + gamma * r(i)

with min-max normalisation of the prompt mass per batch row, the
"recency" or "log" position bias, r(i) = min(1, N_p / N), the prompt-region
floor and the sink anchors, for uniform and ragged rows (true `lengths` and
per-row `prompt_lens`), and for a chunk of a longer sequence scored at its
global positions against its caller's min-max (`position_offset`,
`total_len`, `minmax`). With `importance_source` "query" the min-max
normalised observation-window mass (`ops/attention.query_attention_mass`)
replaces the prompt mass in the alpha term, and with "both" their
elementwise max does. `cumulative_scores` is the running mean over layers.
The sequence-sharded `axis_name` is not ported yet.
"""

from __future__ import annotations

import torch

from ..config import CompressionConfig


def minmax_normalize(x: torch.Tensor, eps: float = 1e-8,
                     valid: torch.Tensor = None) -> torch.Tensor:
    """Per-row min-max normalisation to [0, 1]; constant rows map to 0.
    With `valid`, min and max are taken over valid entries only."""
    if valid is not None:
        big = torch.finfo(torch.float32).max
        row_min = torch.where(valid, x, big).amin(dim=-1, keepdim=True)
        row_max = torch.where(valid, x, -big).amax(dim=-1, keepdim=True)
    else:
        row_min = x.amin(dim=-1, keepdim=True)
        row_max = x.amax(dim=-1, keepdim=True)
    denom = row_max - row_min
    safe = denom > eps
    return torch.where(safe, (x - row_min) / torch.where(
        safe, denom, torch.ones_like(denom)), torch.zeros_like(x))


def context_relevance(seq_len: int, prompt_len: int) -> float:
    """r(i) = min(1, N_p / N), a scalar broadcast over positions."""
    return min(1.0, prompt_len / seq_len)


def importance_scores(
    prompt_mass: torch.Tensor,
    layer_idx: int,
    seq_len: int,
    prompt_len: int,
    cfg: CompressionConfig,
    lengths: torch.Tensor = None,
    prompt_lens: torch.Tensor = None,
    position_offset: int = 0,
    total_len: int = None,
    minmax: tuple = None,
    axis_name: str = None,
    query_mass: torch.Tensor = None,
) -> torch.Tensor:
    """Three-term importance score for every token of a layer.

    prompt_mass: [B, S] raw prompt attention mass; seq_len: S (the padding
    bucket for ragged rows; the LOCAL length when scoring a chunk of a
    longer sequence). lengths: optional [B] true (global) lengths: the mass
    is normalised over each row's valid tokens, and the position bias and
    relevance follow the true length. prompt_lens: optional [B] per-row
    prompt lengths (default `prompt_len`), also for the prompt floor.
    position_offset: global position of local token 0 (a host int);
    total_len: the global length T for the bias and relevance denominators
    (default seq_len). minmax: optional ([B, 1] row_min, [B, 1] row_max)
    that replaces the mass's own min-max, as a chunk is scored against its
    caller's range. query_mass: optional [B, S] observation-window mass,
    used when cfg.importance_source is "query" (it replaces the normalised
    prompt mass) or "both" (the elementwise max of the two normalised
    masses); it normalises over the valid tokens and is refused with
    `minmax` (the chunked prefill scores it at finish over full buffers).
    Returns [B, S] float32. The sharded `axis_name` raises until ROADMAP
    item 18 ports it.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "sequence-sharded importance is not ported yet (ROADMAP Queue 1, "
            "item 18)")
    dev = prompt_mass.device
    mass = prompt_mass.float()
    total = total_len if total_len is not None else seq_len
    gpos = torch.arange(seq_len, device=dev)[None, :] + position_offset
    valid = None if lengths is None else gpos < lengths[:, None]
    if minmax is not None:
        row_min, row_max = minmax
        denom = row_max - row_min
        safe = denom > 1e-8
        normalized = torch.where(
            safe, (mass - row_min) / torch.where(safe, denom,
                                                 torch.ones_like(denom)),
            torch.zeros_like(mass))
    else:
        normalized = minmax_normalize(mass, valid=valid)
    if cfg.importance_source != "prompt" and query_mass is not None:
        if minmax is not None:
            raise NotImplementedError(
                "query-guided importance is not supported on the "
                "chunked-selection (minmax-override) path; the chunked "
                "prefill scores the query mass at finish over full buffers "
                "(models/llama.py prefill_chunked_finish)")
        normalized_q = minmax_normalize(query_mass.float(), valid=valid)
        normalized = (normalized_q if cfg.importance_source == "query"
                      else torch.maximum(normalized, normalized_q))
    w_l = cfg.layer_weights[layer_idx]
    term1 = cfg.alpha * normalized * w_l
    recency = cfg.position_bias_mode == "recency"
    pos = (torch.arange(1, seq_len + 1, dtype=torch.float32, device=dev)
           + position_offset)
    if lengths is not None:
        lens = torch.clamp(lengths.float(), min=2.0)[:, None]
        pos = pos[None, :]
        if recency:
            w = (torch.full_like(lens, float(cfg.recency_window))
                 if cfg.recency_window else
                 torch.clamp(torch.floor(lens / 4.0), 16.0, 2048.0))
            w = torch.minimum(torch.clamp(w, min=1.0), lens)
            term2 = cfg.beta * torch.clamp(1.0 - (lens - pos) / w, 0.0, 1.0)
        else:
            term2 = cfg.beta * torch.log(pos) / torch.log(lens)
        p_lens = (prompt_lens.float()[:, None] if prompt_lens is not None
                  else float(prompt_len))
        term3 = cfg.gamma * torch.clamp(p_lens / lens, max=1.0)
    elif recency:
        w = float(cfg.recency_window_for(total))
        term2 = cfg.beta * torch.clamp(1.0 - (float(total) - pos) / w,
                                       0.0, 1.0)[None, :]
        term3 = cfg.gamma * context_relevance(total, prompt_len)
    else:
        if total <= 1:
            term2 = torch.zeros((1, seq_len), dtype=torch.float32,
                                device=dev)
        else:
            # float32 log on the host: a 0-dim CPU tensor broadcasts
            # without a host-to-device copy.
            log_len = torch.log(torch.tensor(float(total)))
            term2 = cfg.beta * (torch.log(pos) / log_len)[None, :]
        term3 = cfg.gamma * context_relevance(total, prompt_len)
    scores = term1 + term2 + term3
    # Anchor boosts carry a small earliest-first ramp so anchored tokens
    # order deterministically whatever float noise the mass carries; the
    # anchors are the first GLOBAL positions.
    ramp = 5e-4 * gpos.float()
    if cfg.prompt_region_floor:
        if prompt_lens is not None:
            floor_mask = gpos < torch.ceil(
                prompt_lens.float() * cfg.prompt_region_floor)[:, None]
        else:
            floor_mask = gpos < cfg.prompt_floor_length(prompt_len)
        scores = torch.where(floor_mask, scores + 1.0 + cfg.theta_h - ramp,
                             scores)
    if cfg.sink_tokens:
        scores = torch.where(gpos < cfg.sink_tokens,
                             scores + 2.0 + cfg.theta_h - ramp, scores)
    return scores


def cumulative_scores(per_layer_scores: torch.Tensor) -> torch.Tensor:
    """Running mean over layers: [L, B, S] → out[l] = mean(scores[0..l]),
    the divisor the true number of layers present."""
    csum = torch.cumsum(per_layer_scores, dim=0)
    denom = torch.arange(1, per_layer_scores.shape[0] + 1, dtype=csum.dtype,
                         device=csum.device)
    return csum / denom[:, None, None]
