"""Real-time prefill KV compression pipeline (PyTorch).

Port of the JAX package's `compression/compressor.py` for one device,
uniform or ragged batches: score → precision labels → budgeted tier
selection → quantize + pack each tier pool, with the same per-layer
statistics, and the host-side summary over layers. Sequence-sharded and
chunked-minmax compression are not ported yet (ROADMAP Queue 1, item 18).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import HIGH, LOW, MID, CompressionConfig, ModelConfig
from ..ops.importance import importance_scores
from ..ops.quantization import (assign_precision, dequantize_tier,
                                memory_report, quantize_tier)
from ..ops.selection import select_tokens
from .kv_cache import CompressedLayerCache, TierCache, model_dtype


def _gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather [B, S, H, D] tokens at idx [B, N] → [B, N, H, D]."""
    b, n = idx.shape
    full = idx.long()[:, :, None, None].expand(b, n, *x.shape[2:])
    return torch.gather(x, 1, full)


def compress_layer_kv(
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_mass: torch.Tensor,
    layer_idx: int,
    cfg: CompressionConfig,
    model_cfg: ModelConfig,
    token_valid: torch.Tensor = None,
    prompt_lens: torch.Tensor = None,
) -> Tuple[CompressedLayerCache, Dict[str, torch.Tensor]]:
    """Compress one layer's prefill K/V into packed tier pools.

    k, v: [B, S, H_kv, D] RoPE'd keys / values; prompt_mass: [B, S].
    token_valid: optional [B, S] bool for right-padded ragged rows: padding
    is never stored, and scores, budgets and stats follow the true lengths
    (`importance_min` / `importance_max` still span the padding, as in the
    reference). prompt_lens: optional [B] per-row prompt lengths.
    Returns (cache, stats): the layer's `CompressedLayerCache` and a dict of
    per-row statistics with the reference's keys.
    """
    batch, seq_len, num_kv_heads, head_dim = k.shape
    prompt_len = cfg.prompt_length(seq_len)
    group_size = cfg.quant_group_size or head_dim
    store_dtype = model_dtype(model_cfg)

    lengths = token_valid.sum(dim=-1) if token_valid is not None else None
    scores = importance_scores(prompt_mass, layer_idx, seq_len, prompt_len,
                               cfg, lengths=lengths, prompt_lens=prompt_lens)
    labels, prec_stats = assign_precision(scores, cfg)
    sel = select_tokens(scores, labels, layer_idx, cfg,
                        token_valid=token_valid, prompt_lens=prompt_lens)

    tiers = []
    for slot, tier in enumerate((HIGH, MID, LOW)):
        idx, valid = sel.indices[slot], sel.valid[slot]
        bits = cfg.tier_bits(tier)
        chunk = cfg.tier_chunk(idx.shape[1])
        k_stored, k_scale, k_zp = quantize_tier(
            _gather_tokens(k, idx), bits, group_size, store_dtype,
            clip_frac=cfg.quant_clip_frac, chunk=chunk)
        v_stored, v_scale, v_zp = quantize_tier(
            _gather_tokens(v, idx), bits, group_size, store_dtype,
            clip_frac=cfg.quant_clip_frac, chunk=chunk)
        tiers.append(TierCache(
            k_stored=k_stored, v_stored=v_stored,
            k_scale=k_scale, k_zp=k_zp, v_scale=v_scale, v_zp=v_zp,
            positions=idx.to(torch.int32), valid=valid, chunk=chunk))
    cache = CompressedLayerCache(tiers=tuple(tiers))

    kept_labels = torch.cat([
        torch.full(sel.indices[0].shape, HIGH, device=k.device),
        torch.full(sel.indices[1].shape, MID, device=k.device),
        torch.full(sel.indices[2].shape, LOW, device=k.device),
    ], dim=-1)
    kept_valid = torch.cat(sel.valid, dim=-1)
    mem = memory_report(kept_labels, kept_valid, cfg,
                        head_dim * num_kv_heads,
                        original_tokens=(token_valid.sum()
                                         if token_valid is not None
                                         else batch * seq_len),
                        group_size=group_size)

    kept = sel.kept_mask.sum(dim=-1)
    true_len = (lengths if lengths is not None
                else torch.full((batch,), seq_len, device=k.device))
    stats = {
        "seq_len": true_len,
        "kept_tokens": kept,
        "compression_ratio": kept / true_len,
        "token_memory_savings": 1.0 - kept / true_len,
        "importance_mean": scores.mean(dim=-1),
        "importance_std": scores.std(dim=-1, correction=0),
        "importance_min": scores.amin(dim=-1),
        "importance_max": scores.amax(dim=-1),
        "label_high_ratio": prec_stats["high_ratio"],
        "label_medium_ratio": prec_stats["medium_ratio"],
        "label_low_ratio": prec_stats["low_ratio"],
        "stored_high": sel.stats["high_count"],
        "stored_medium": sel.stats["medium_count"],
        "stored_low": sel.stats["low_count"],
        "byte_compression_ratio": mem["compression_ratio"],
        "byte_memory_savings": mem["memory_savings"],
        "budget_utilization": sel.stats["budget_utilization"],
        "avg_selected_importance": sel.stats["avg_importance"],
        "demoted_count": sel.stats["demoted_count"],
    }
    return cache, stats


def dequantize_layer_cache(
    cache: CompressedLayerCache,
    cfg: CompressionConfig,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize a layer cache back to dense K/V.

    Returns (k, v, positions, valid): k/v [B, N_total, H, D], positions and
    valid [B, N_total], tiers concatenated HIGH|MID|LOW. This is the plain
    decode path; the fused decode kernel reads the packed pools directly.
    """
    ks, vs, ps, valids = [], [], [], []
    for tier, t in zip((HIGH, MID, LOW), cache.tiers):
        if t.capacity == 0:
            continue
        bits = cfg.tier_bits(tier)
        chunk = t.chunk if t.chunk is not None else cfg.tier_chunk(t.capacity)
        ks.append(dequantize_tier(t.k_stored, t.k_scale, t.k_zp, bits, dtype,
                                  chunk=chunk))
        vs.append(dequantize_tier(t.v_stored, t.v_scale, t.v_zp, bits, dtype,
                                  chunk=chunk))
        ps.append(t.positions)
        valids.append(t.valid)
    return (torch.cat(ks, dim=1), torch.cat(vs, dim=1),
            torch.cat(ps, dim=1), torch.cat(valids, dim=1))


def _build_summary(mean_lk, sum_lk, ki: Dict[str, int], n: int
                   ) -> Dict[str, float]:
    """Summary dict from [L, K] per-layer (mean, sum) stat matrices."""
    avg = lambda key: float(mean_lk[:, ki[key]].mean())
    total_high = float(sum_lk[:, ki["stored_high"]].sum())
    total_med = float(sum_lk[:, ki["stored_medium"]].sum())
    total_low = float(sum_lk[:, ki["stored_low"]].sum())
    total_tokens = max(total_high + total_med + total_low, 1.0)
    initial_seq = float(mean_lk[0, ki["seq_len"]])
    final_kept = float(mean_lk[-1, ki["kept_tokens"]])
    return {
        "total_layers_processed": n,
        "avg_compression_ratio": avg("compression_ratio"),
        "avg_memory_savings": avg("byte_memory_savings"),
        "avg_token_savings": avg("token_memory_savings"),
        "cumulative_compression": final_kept / max(initial_seq, 1.0),
        "overall_memory_savings": 1.0 - final_kept / max(initial_seq, 1.0),
        "avg_budget_utilization": avg("budget_utilization"),
        "precision_distribution": {
            "high_ratio": total_high / total_tokens,
            "medium_ratio": total_med / total_tokens,
            "low_ratio": total_low / total_tokens,
        },
    }


def summarize_layer_stats(layer_stats: List[Dict[str, torch.Tensor]]
                          ) -> Dict[str, float]:
    """Aggregate per-layer stats into Python floats: the per-layer (mean,
    sum) of every stat go to the host in one [L, K, 2] float32 transfer."""
    if not layer_stats:
        return {}
    keys = tuple(sorted(layer_stats[0].keys()))
    rows = []
    for s in layer_stats:
        vals = [torch.as_tensor(s[k]).float() for k in keys]
        rows.append(torch.stack([torch.stack([x.mean(), x.sum()])
                                 for x in vals]))
    stacked = torch.stack(rows).cpu().numpy().astype(np.float32)
    ki = {k: i for i, k in enumerate(keys)}
    return _build_summary(stacked[:, :, 0], stacked[:, :, 1], ki,
                          len(layer_stats))
