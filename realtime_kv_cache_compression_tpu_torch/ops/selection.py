"""Budgeted selective token propagation with static tier capacities (PyTorch).

Port of the JAX package's `ops/selection.py`, `selection_mode="topk_prefix"`:
sort by importance (stable, descending), keep the maximal prefix whose
cumulative byte cost fits the layer budget, cap the count at the exact token
limit, fall back to the top max(1, S * fallback_frac) tokens when nothing
fits, and bucket the survivors into per-tier slot arrays of static capacity
(quantile or threshold tier mode, with demotion when a threshold-mode pool
is full). Original token positions ride along with every slot. Ragged rows
(`token_valid`) take their budget from their true length; a local chunk of a
longer sequence (`total_len`) keeps uniform capacities.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..config import HIGH, LOW, MID, CompressionConfig
from .quantization import token_costs


@dataclasses.dataclass
class Selection:
    """Result of budgeted selection, arranged per precision tier.

    indices[t]: [B, cap_t] int32 original positions in descending importance
      order within the tier (unused slots point at position 0);
    valid[t]: [B, cap_t] bool; tiers ordered (HIGH, MID, LOW).
    kept_mask: [B, S] union mask over tiers; stats: per-row selection metrics.
    """

    indices: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    valid: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    kept_mask: torch.Tensor
    stats: Dict[str, torch.Tensor]


def select_tokens(
    scores: torch.Tensor,
    labels: torch.Tensor,
    layer_idx: int,
    cfg: CompressionConfig,
    token_valid: torch.Tensor = None,
    total_len: int = None,
    prompt_lens: torch.Tensor = None,
) -> Selection:
    """Select tokens under the layer byte budget, bucketed into tier slots.

    scores: [B, S] importance; labels: [B, S] threshold precision labels
    (costs, and tiers in threshold mode). token_valid: optional [B, S] bool
    for ragged rows: padding is never selected, and the budget, token limit
    and fallback floor follow each row's true length. prompt_lens: optional
    [B] per-row prompt lengths: the HIGH tier's anchor growth follows each
    row's floored prompt region. total_len: the GLOBAL length when scores
    are a local chunk of a longer sequence; such local selection does not
    grow the HIGH tier for anchors (`tier_capacities(grow_for_anchors=
    False)`), so every chunk's capacities stay uniform: anchors are still
    selected (their boost), but get the HIGH tier only as far as it holds
    them. `selection_mode="exact_greedy"` (ROADMAP item 4) is not ported
    yet.
    """
    if cfg.selection_mode == "exact_greedy":
        raise NotImplementedError(
            "selection_mode='exact_greedy' is not ported yet (ROADMAP "
            "Queue 1, item 4)")
    dev = scores.device
    batch, seq_len = scores.shape
    ratio = cfg.layer_ratio(layer_idx)
    local = total_len is not None
    caps = cfg.tier_capacities(seq_len, layer_idx,
                               grow_for_anchors=not local)

    scores = scores.float()
    if token_valid is not None:
        scores = torch.where(token_valid, scores, -torch.inf)
        lens = token_valid.sum(dim=-1, keepdim=True).float()      # [B, 1]
        budget = lens * ratio
        limit = torch.minimum(
            torch.maximum(torch.ceil(lens * ratio), torch.clamp(
                torch.ceil(lens * cfg.fallback_frac), min=1.0)),
            lens).to(torch.int32)
        k_fb = torch.clamp((lens * cfg.fallback_frac).to(torch.int32),
                           min=1)
    else:
        budget = float(seq_len) * ratio
        limit = cfg.token_limit(seq_len, layer_idx)
        k_fb = max(1, int(seq_len * cfg.fallback_frac))
    costs = token_costs(labels, cfg)

    order = torch.argsort(-scores, dim=-1, stable=True)            # [B, S]
    sorted_costs = torch.gather(costs, 1, order)
    sel_sorted = torch.cumsum(sorted_costs, dim=-1) <= budget

    rank = torch.arange(seq_len, device=dev)[None, :]
    none_selected = sel_sorted.sum(dim=-1, keepdim=True) == 0
    sel_sorted = torch.where(none_selected, rank < k_fb, sel_sorted)
    if token_valid is not None:
        # Padding sorts last (-inf) and is never selected, not even by the
        # fallback floor.
        sel_sorted &= torch.gather(token_valid, 1, order)

    sel_rank = torch.cumsum(sel_sorted.to(torch.int32), dim=-1) - 1
    sel_sorted = sel_sorted & (sel_rank < limit)

    demoted = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.tier_mode == "quantile":
        # Boundaries as float32 ceils of the (per-row, for ragged rows)
        # limit, like the reference computes them.
        fh, fm, _ = cfg.tier_fractions
        # torch.full, not torch.tensor: a host scalar copied to the device
        # would wait for the queued prefill once per layer.
        lim = (limit if torch.is_tensor(limit) else torch.full(
            (1, 1), limit, dtype=torch.int32, device=dev))
        lim_f = lim.float()
        n_h = torch.minimum(torch.ceil(lim_f * fh), lim_f).to(torch.int32)
        anchors = 0 if local else cfg.anchor_count(seq_len)
        if anchors and prompt_lens is not None:
            anchors = torch.clamp(torch.ceil(
                prompt_lens.float() * cfg.prompt_region_floor
            ).to(torch.int32)[:, None], min=cfg.sink_tokens)
        n_h = torch.maximum(n_h, torch.minimum(anchors, lim)
                            if torch.is_tensor(anchors)
                            else torch.clamp(lim, max=anchors))
        n_m = torch.minimum(torch.ceil(lim_f * fm),
                            (lim - n_h).float()).to(torch.int32)
        tier_sorted = torch.where(
            sel_rank < n_h, HIGH, torch.where(sel_rank < n_h + n_m, MID, LOW))
    else:
        labels_sorted = torch.gather(labels, 1, order)
        n_h_lab = (sel_sorted & (labels_sorted == HIGH)).sum(-1, keepdim=True)
        n_m_lab = (sel_sorted & (labels_sorted == MID)).sum(-1, keepdim=True)
        n_sel_r = sel_sorted.sum(dim=-1, keepdim=True)
        c_h, c_m, c_l = caps
        hi_end = torch.clamp(torch.maximum(n_h_lab, n_sel_r - c_m - c_l),
                             0, c_h)
        seg_m = torch.clamp(torch.maximum(n_h_lab + n_m_lab - hi_end,
                                          n_sel_r - hi_end - c_l), 0, c_m)
        mid_end = hi_end + seg_m
        tier_sorted = torch.where(sel_rank < hi_end, HIGH,
                                  torch.where(sel_rank < mid_end, MID, LOW))
        demoted = (torch.clamp(n_h_lab - hi_end, min=0)
                   + torch.clamp(n_h_lab + n_m_lab
                                 - torch.maximum(mid_end, n_h_lab), min=0)
                   )[:, 0].to(torch.int32)

    tier_caps = {HIGH: caps[0], MID: caps[1], LOW: caps[2]}
    indices, valids, tier_counts = {}, {}, {}
    kept_sorted = torch.zeros_like(sel_sorted)
    for tier in (HIGH, MID, LOW):
        cap_t = tier_caps[tier]
        flag = sel_sorted & (tier_sorted == tier)            # sorted order
        t_rank = torch.cumsum(flag.to(torch.int32), dim=-1) - 1
        n_t = flag.sum(dim=-1)
        tier_counts[tier] = n_t
        kept_sorted |= flag & (t_rank < cap_t)
        if cap_t == 0:
            indices[tier] = torch.zeros((batch, 0), dtype=torch.int32,
                                        device=dev)
            valids[tier] = torch.zeros((batch, 0), dtype=torch.bool,
                                       device=dev)
            continue
        # Scatter original positions into tier slots; overflow and
        # non-members go to a sacrificial trailing slot.
        dest = torch.where(flag & (t_rank < cap_t), t_rank,
                           torch.full_like(t_rank, cap_t)).long()
        slots = torch.zeros((batch, cap_t + 1), dtype=torch.int64,
                            device=dev)
        slots.scatter_(1, dest, order)
        indices[tier] = slots[:, :cap_t].to(torch.int32)
        valids[tier] = (torch.arange(cap_t, device=dev)[None, :]
                        < torch.clamp(n_t, max=cap_t)[:, None])

    kept_mask = torch.zeros((batch, seq_len), dtype=torch.bool, device=dev)
    kept_mask.scatter_(1, order, kept_sorted)

    spent = torch.where(sel_sorted, sorted_costs,
                        torch.zeros_like(sorted_costs)).sum(dim=-1)
    n_selected = sel_sorted.sum(dim=-1)
    sorted_scores = torch.gather(scores, 1, order)
    avg_imp = (torch.where(sel_sorted, sorted_scores,
                           torch.zeros_like(sorted_scores)).sum(dim=-1)
               / torch.clamp(n_selected, min=1))
    if token_valid is not None:
        utilization = spent / torch.clamp(budget[:, 0], min=1e-9)
        true_len = token_valid.sum(dim=-1)
    else:
        utilization = spent / max(budget, 1e-9)
        true_len = seq_len
    stats = {
        "selected_count": n_selected,
        "budget_utilization": utilization,
        "avg_importance": avg_imp,
        "high_count": tier_counts[HIGH],
        "medium_count": tier_counts[MID],
        "low_count": tier_counts[LOW],
        "propagation_ratio": torch.full((batch,), ratio, device=dev),
        "demoted_count": demoted,
        "compression_ratio": kept_mask.sum(dim=-1) / true_len,
    }
    return Selection(
        indices=(indices[HIGH], indices[MID], indices[LOW]),
        valid=(valids[HIGH], valids[MID], valids[LOW]),
        kept_mask=kept_mask,
        stats=stats,
    )
