"""Prompt-guided token importance scoring (PyTorch).

Port of the JAX package's `ops/importance.py` for the prompt-mass source:

    s_i = alpha * Â_P,i * w_l + beta * b_pos(i) + gamma * r(i)

with min-max normalisation of the prompt mass per batch row, the
"recency" or "log" position bias, r(i) = min(1, N_p / N), the prompt-region
floor and the sink anchors. The query-window sources ("query", "both"),
ragged rows and the sequence-sharded arguments are not ported yet.
"""

from __future__ import annotations

import torch

from ..config import CompressionConfig


def minmax_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-row min-max normalisation to [0, 1]; constant rows map to 0."""
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
    minmax: tuple = None,
    axis_name: str = None,
    query_mass: torch.Tensor = None,
) -> torch.Tensor:
    """Three-term importance score for every token of a layer.

    prompt_mass: [B, S] raw prompt attention mass. Returns [B, S] float32.
    The arguments after `cfg` are the JAX package's ragged, sharded and
    query-mass inputs; they raise until those paths are ported.
    """
    if cfg.importance_source != "prompt" or query_mass is not None:
        raise NotImplementedError(
            "importance_source 'query'/'both' is not ported yet")
    if lengths is not None or prompt_lens is not None:
        raise NotImplementedError("ragged importance is not ported yet")
    if minmax is not None or axis_name is not None:
        raise NotImplementedError(
            "sharded/chunked importance is not ported yet")
    dev = prompt_mass.device
    mass = prompt_mass.float()
    normalized = minmax_normalize(mass)
    w_l = cfg.layer_weights[layer_idx]
    term1 = cfg.alpha * normalized * w_l
    pos = torch.arange(1, seq_len + 1, dtype=torch.float32, device=dev)
    if cfg.position_bias_mode == "recency":
        w = float(cfg.recency_window_for(seq_len))
        term2 = cfg.beta * torch.clamp(1.0 - (float(seq_len) - pos) / w,
                                       0.0, 1.0)[None, :]
    elif seq_len <= 1:
        term2 = torch.zeros((1, seq_len), dtype=torch.float32, device=dev)
    else:
        # float32 log on the host: a 0-dim CPU tensor broadcasts without a
        # host-to-device copy.
        log_len = torch.log(torch.tensor(float(seq_len)))
        term2 = cfg.beta * (torch.log(pos) / log_len)[None, :]
    term3 = cfg.gamma * context_relevance(seq_len, prompt_len)
    scores = term1 + term2 + term3
    # Anchor boosts carry a small earliest-first ramp so anchored tokens
    # order deterministically whatever float noise the mass carries.
    gpos = torch.arange(seq_len, device=dev)[None, :]
    ramp = 5e-4 * gpos.float()
    if cfg.prompt_region_floor:
        floor_mask = gpos < cfg.prompt_floor_length(prompt_len)
        scores = torch.where(floor_mask, scores + 1.0 + cfg.theta_h - ramp,
                             scores)
    if cfg.sink_tokens:
        scores = torch.where(gpos < cfg.sink_tokens,
                             scores + 2.0 + cfg.theta_h - ramp, scores)
    return scores
