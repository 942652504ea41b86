"""Real-time prefill KV compression pipeline (PyTorch).

Port of the JAX package's `compression/compressor.py` for one device,
uniform or ragged batches: score → precision labels → budgeted tier
selection → quantize + pack each tier pool, with the same per-layer
statistics, and the host-side summary over layers. A chunk of a longer
sequence compresses at its global positions against its caller's mass
range (`shard_offset`, `total_len`, `minmax`), into pools that concatenate
along the slot axis: `empty_layer_cache` preallocates them for the
compressed-prefix chunked prefill and `update_cache_chunk` writes one
chunk's pools in place; `concat_layer_caches` and
`compress_layer_kv_chunked` are the single-device chunked-selection policy.
`query_mass` feeds query-guided importance (`importance_source` "query" /
"both"). With the sequence sharded over a process group (`group`, the
sequence-parallel prefill's `sharded_compression`), each rank compresses
its own tokens at their global positions against the global mass range,
with the budget split evenly, and its stats aggregate exactly over the
group (`_aggregate_sharded_stats`): the policy and the caches of
`compress_layer_kv_chunked` with one chunk per rank. The aggregated stats
are the same tensors on every rank, so reading them needs no collective
(the JAX package's `_host_get` gathers stats that a multi-host mesh
shards over processes; that readback waits for the multi-host slice).
`summarize_layer_stats` and `summarize_layer_stats_per_row` bring the
per-layer stats to the host in one transfer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import comm
from ..config import HIGH, LOW, MID, CompressionConfig, ModelConfig
from ..ops.importance import importance_scores
from ..ops.quantization import (assign_precision, dequantize_tier,
                                memory_report, quantize_tier)
from ..ops.selection import select_tokens
from .kv_cache import CompressedLayerCache, TierCache, model_dtype


def identify_prompt_length(seq_len: int, cfg: CompressionConfig) -> int:
    """Static prompt prefix length for a sequence of seq_len tokens."""
    return cfg.prompt_length(seq_len)


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
    shard_offset: int = 0,
    total_len: int = None,
    minmax: tuple = None,
    chunk_lengths: torch.Tensor = None,
    query_mass: torch.Tensor = None,
    group=None,
    data_group=None,
    kv_heads_total: int = None,
) -> Tuple[CompressedLayerCache, Dict[str, torch.Tensor]]:
    """Compress one layer's prefill K/V into packed tier pools.

    k, v: [B, S, H_kv, D] RoPE'd keys / values; prompt_mass: [B, S].
    token_valid: optional [B, S] bool for right-padded ragged rows: padding
    is never stored, and scores, budgets and stats follow the true lengths
    (`importance_min` / `importance_max` still span the padding, as in the
    reference). prompt_lens: optional [B] per-row prompt lengths.

    A chunk of a longer sequence: shard_offset is the global position of
    local token 0 (a host int; stored positions are global), total_len the
    global length, and minmax ([B, 1] min, [B, 1] max) the mass range the
    chunk is normalised against. With minmax the pools record their packing
    chunk (the tier's capacity when it packed as one chunk), so chunks'
    pools concatenate along the slot axis; a chunk shorter than total_len
    selects locally (no anchor growth of the HIGH tier). chunk_lengths: [B]
    global true lengths, required with minmax on ragged rows. query_mass:
    optional [B, S] observation-window mass
    (`ops/attention.query_attention_mass`) for the alpha term when
    cfg.importance_source is "query" or "both".
    group: the process group of sequence shards, fully sharded
    compression: k, v, prompt_mass (and query_mass, token_valid) are this
    rank's [B, S/n] slice at global offset shard_offset of total_len
    tokens; the mass range is the global one (all-reduced), ragged rows
    score with their global true lengths (the valid counts summed over the
    group) and take prompt_lens global, each rank selects locally with the
    budget split evenly, and the stats come back aggregated over the group
    (the same on every rank). The rank's pools record their packing chunk,
    so the ranks' caches concatenate along the slot axis in rank order.
    Under tensor and data parallelism (`parallel/sharding.py`) k and v
    hold a rank's rows and kv heads: `data_group` sums the batch-wide
    counts of the label and byte stats over the data axis, and
    `kv_heads_total` (default: k's) is the model's kv-head count, the
    width the byte stats count, so both are the whole model's and batch's.
    Returns (cache, stats): the layer's `CompressedLayerCache` and a dict of
    per-row statistics with the reference's keys.
    """
    batch, seq_len, num_kv_heads, head_dim = k.shape
    sharded = group is not None or minmax is not None
    if (minmax is not None and group is None and token_valid is not None
            and chunk_lengths is None):
        raise ValueError("chunked-minmax ragged compression needs "
                         "chunk_lengths (global per-row true lengths)")
    total = total_len if total_len is not None else seq_len
    prompt_len = identify_prompt_length(total, cfg)
    group_size = cfg.quant_group_size or head_dim
    store_dtype = model_dtype(model_cfg)

    lengths = token_valid.sum(dim=-1) if token_valid is not None else None
    score_lengths = chunk_lengths if chunk_lengths is not None else lengths
    if group is not None and lengths is not None:
        score_lengths = comm.all_reduce_sum(lengths, group)
    scores = importance_scores(
        prompt_mass, layer_idx, seq_len, prompt_len, cfg,
        lengths=score_lengths, prompt_lens=prompt_lens,
        position_offset=shard_offset, total_len=total, minmax=minmax,
        group=group, query_mass=query_mass)
    labels, prec_stats = assign_precision(scores, cfg, group=data_group)
    # A chunk covering the whole sequence is the plain path, exactly.
    local_window = sharded and seq_len != total
    sel = select_tokens(scores, labels, layer_idx, cfg,
                        token_valid=token_valid,
                        total_len=total if local_window else None,
                        prompt_lens=prompt_lens)

    tiers = []
    for slot, tier in enumerate((HIGH, MID, LOW)):
        idx, valid = sel.indices[slot], sel.valid[slot]
        bits = cfg.tier_bits(tier)
        chunk = cfg.tier_chunk(idx.shape[1])
        cache_chunk = (_concat_chunk(idx.shape[1], bits, chunk) if sharded
                       else chunk)
        k_stored, k_scale, k_zp = quantize_tier(
            _gather_tokens(k, idx), bits, group_size, store_dtype,
            clip_frac=cfg.quant_clip_frac, chunk=chunk)
        v_stored, v_scale, v_zp = quantize_tier(
            _gather_tokens(v, idx), bits, group_size, store_dtype,
            clip_frac=cfg.quant_clip_frac, chunk=chunk)
        tiers.append(TierCache(
            k_stored=k_stored, v_stored=v_stored,
            k_scale=k_scale, k_zp=k_zp, v_scale=v_scale, v_zp=v_zp,
            positions=idx.to(torch.int32) + shard_offset, valid=valid,
            chunk=cache_chunk))
    cache = CompressedLayerCache(tiers=tuple(tiers))

    kept_labels = torch.cat([
        torch.full(sel.indices[0].shape, HIGH, device=k.device),
        torch.full(sel.indices[1].shape, MID, device=k.device),
        torch.full(sel.indices[2].shape, LOW, device=k.device),
    ], dim=-1)
    kept_valid = torch.cat(sel.valid, dim=-1)
    mem = memory_report(kept_labels, kept_valid, cfg,
                        head_dim * (kv_heads_total or num_kv_heads),
                        original_tokens=(token_valid.sum()
                                         if token_valid is not None
                                         else batch * seq_len),
                        group_size=group_size, group=data_group)

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
    if group is not None:
        stats = _aggregate_sharded_stats(stats, scores, group, kept,
                                         token_valid=token_valid)
    return cache, stats


_SUMMED = ("seq_len", "kept_tokens", "stored_high", "stored_medium",
           "stored_low", "demoted_count")
_AVERAGED = ("label_high_ratio", "label_medium_ratio", "label_low_ratio",
             "byte_compression_ratio", "byte_memory_savings",
             "budget_utilization")


def _aggregate_sharded_stats(stats: Dict[str, torch.Tensor],
                             scores: torch.Tensor, group,
                             kept: torch.Tensor,
                             token_valid: torch.Tensor = None
                             ) -> Dict[str, torch.Tensor]:
    """Exact global stats from each rank's: counts summed; means over
    equal shards, or weighted by each shard's valid tokens on ragged rows
    (token_valid); min and max reduced; the std pooled from E[x] and
    E[x^2]; the ratios recomputed from the summed counts; the mean
    selected importance weighted by each shard's kept count. Three
    collectives: one int64 and one float32 SUM, one MAX."""
    def flat(xs, dtype):
        return torch.cat([x.to(dtype).reshape(-1) for x in xs])

    def unflat(buf, likes):
        out, i = [], 0
        for x in likes:
            out.append(buf[i:i + x.numel()].reshape(x.shape).to(x.dtype))
            i += x.numel()
        return out

    n = comm.rank_and_size(group)[1]
    out = dict(stats)
    ints = [stats[key] for key in _SUMMED]
    for key, x in zip(_SUMMED, unflat(comm.all_reduce_sum(
            flat(ints, torch.int64), group), ints)):
        out[key] = x
    if token_valid is None:
        w_loc = None
        terms = [scores.mean(dim=-1), (scores ** 2).mean(dim=-1)]
        terms += [stats[key] for key in _AVERAGED]
    else:
        w_loc = token_valid.sum(dim=-1).float()                  # [B]
        sc = torch.where(token_valid, scores,
                         torch.zeros((), device=scores.device))
        terms = [sc.sum(dim=-1), (sc ** 2).sum(dim=-1)]
        terms += [stats[key] * w_loc for key in _AVERAGED]
    w_kept = kept.float()
    terms += [stats["avg_selected_importance"] * w_kept, w_kept]
    if w_loc is not None:
        terms.append(w_loc)
    sums = unflat(comm.all_reduce_sum(flat(terms, torch.float32), group),
                  terms)
    if w_loc is None:
        mean_g, sq_g = sums[0] / n, sums[1] / n
        averaged = [x / n for x in sums[2:2 + len(_AVERAGED)]]
    else:
        w_tot = torch.clamp(sums[-1], min=1.0)
        mean_g, sq_g = sums[0] / w_tot, sums[1] / w_tot
        averaged = [x / w_tot for x in sums[2:2 + len(_AVERAGED)]]
    out.update(zip(_AVERAGED, averaged))
    sel_sum, kept_sum = sums[2 + len(_AVERAGED):4 + len(_AVERAGED)]
    out["avg_selected_importance"] = sel_sum / torch.clamp(kept_sum, min=1.0)
    out["importance_mean"] = mean_g
    out["importance_std"] = torch.sqrt(torch.clamp(sq_g - mean_g ** 2,
                                                   min=0.0))
    ends = comm.all_reduce_max(torch.cat([
        -stats["importance_min"].reshape(-1),
        stats["importance_max"].reshape(-1)]).float(), group)
    m = stats["importance_min"].numel()
    out["importance_min"] = (-ends[:m]).reshape(stats["importance_min"].shape)
    out["importance_max"] = ends[m:].reshape(stats["importance_max"].shape)
    out["compression_ratio"] = out["kept_tokens"] / out["seq_len"]
    out["token_memory_savings"] = 1.0 - out["compression_ratio"]
    return out


def _concat_chunk(capacity: int, bits: int, chunk) -> int:
    """Packing chunk a tier records when its pools concatenate with other
    chunks' along the slot axis: the packing chunk, or the whole capacity
    when the tier packed as one chunk, which must then fill whole bytes."""
    if chunk is None and capacity % max(1, 8 // bits):
        raise ValueError(f"chunked compression: tier capacity {capacity} "
                         f"must be a multiple of {max(1, 8 // bits)} "
                         f"({bits}-bit packing)")
    return chunk if chunk is not None else capacity


_TIER_FIELDS = ("k_stored", "v_stored", "k_scale", "k_zp", "v_scale", "v_zp",
                "positions", "valid")


def concat_layer_caches(caches: List[CompressedLayerCache]
                        ) -> CompressedLayerCache:
    """Concatenate per-chunk or per-rank layer caches along the slot axis.
    All parts must share tier shapes and packing chunks (as the chunked
    compression's equal chunks and the sharded compression's equal shards
    do); the result's layout is chunked with that chunk."""
    tiers = []
    for i in range(len(caches[0].tiers)):
        parts = [c.tiers[i] for c in caches]
        chunks = {p.chunk for p in parts}
        if len(chunks) != 1:
            raise ValueError(f"mismatched packing chunks: {chunks}")
        tiers.append(TierCache(
            **{f: torch.cat([getattr(p, f) for p in parts], dim=1)
               for f in _TIER_FIELDS}, chunk=parts[0].chunk))
    return CompressedLayerCache(tiers=tuple(tiers))


def empty_layer_cache(batch: int, chunk_size: int, n_chunks: int,
                      layer_idx: int, cfg: CompressionConfig,
                      model_cfg: ModelConfig,
                      device=None) -> CompressedLayerCache:
    """All-invalid layer cache sized for `n_chunks` chunk compressions of
    `chunk_size` tokens, on `device`: the shapes, dtypes and packing chunks
    one chunk's `compress_layer_kv(minmax=...)` gives, with the slot axis
    times n_chunks (the layout of `concat_layer_caches`). Invalid slots
    hold position 0 and valid False; every reader masks on `valid`."""
    h, d = model_cfg.num_kv_heads, model_cfg.head_dim
    groups = d // (cfg.quant_group_size or d)
    local = n_chunks > 1  # as compress_layer_kv's local_window
    caps = cfg.tier_capacities(chunk_size, layer_idx,
                               grow_for_anchors=not local)
    tiers = []
    for tier, cap in zip((HIGH, MID, LOW), caps):
        bits = cfg.tier_bits(tier)
        chunk = cfg.tier_chunk(cap)
        cache_chunk = _concat_chunk(cap, bits, chunk)
        if bits == 16:
            rows, code_dtype = cap, model_dtype(model_cfg)
        else:
            per_byte = 8 // bits
            rows = (cap // chunk) * -(-chunk // per_byte) if chunk else \
                -(-cap // per_byte)
            code_dtype = torch.uint8

        def zeros(shape, dtype):
            return torch.zeros((batch, shape[0] * n_chunks) + shape[1:],
                               dtype=dtype, device=device)

        tiers.append(TierCache(
            k_stored=zeros((rows, h, d), code_dtype),
            v_stored=zeros((rows, h, d), code_dtype),
            **{f: zeros((cap, h, groups), torch.float32)
               for f in ("k_scale", "k_zp", "v_scale", "v_zp")},
            positions=zeros((cap,), torch.int32),
            valid=zeros((cap,), torch.bool), chunk=cache_chunk))
    return CompressedLayerCache(tiers=tuple(tiers))


def update_cache_chunk(cache: CompressedLayerCache,
                       chunk_cache: CompressedLayerCache,
                       chunk_idx: int) -> CompressedLayerCache:
    """Write one chunk's freshly compressed pools into slot range
    `chunk_idx` (a host int) of a preallocated `empty_layer_cache`, in
    place; returns `cache`."""
    for big, small in zip(cache.tiers, chunk_cache.tiers):
        for f in _TIER_FIELDS:
            dst, src = getattr(big, f), getattr(small, f)
            n = src.shape[1]
            dst[:, chunk_idx * n:(chunk_idx + 1) * n] = src
    return cache


def compress_layer_kv_chunked(
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_mass: torch.Tensor,
    layer_idx: int,
    cfg: CompressionConfig,
    model_cfg: ModelConfig,
    n_chunks: int,
    token_valid: torch.Tensor = None,
    prompt_lens: torch.Tensor = None,
) -> Tuple[CompressedLayerCache, Dict[str, torch.Tensor]]:
    """Chunked-selection compression: scores against the exact global mass
    min-max, selection per chunk of S / n_chunks tokens with the budget
    split evenly, pools concatenated (`concat_layer_caches`); the
    single-device reference of sequence-sharded compression. Ragged rows:
    token_valid (+ prompt_lens), each chunk's budget following its own
    valid count. Stats aggregate exactly over the chunks."""
    b, s = k.shape[:2]
    if s % n_chunks:
        raise ValueError(f"S={s} must divide n_chunks={n_chunks}")
    s_loc = s // n_chunks
    mass = prompt_mass.float()
    if token_valid is None:
        mn = mass.amin(dim=-1, keepdim=True)
        mx = mass.amax(dim=-1, keepdim=True)
    else:
        mn = torch.where(token_valid, mass, torch.inf).amin(dim=-1,
                                                            keepdim=True)
        mx = torch.where(token_valid, mass, -torch.inf).amax(dim=-1,
                                                             keepdim=True)
    lengths_g = token_valid.sum(dim=-1) if token_valid is not None else None
    caches, parts = [], []
    for c in range(n_chunks):
        sl = slice(c * s_loc, (c + 1) * s_loc)
        cache_c, st_c = compress_layer_kv(
            k[:, sl], v[:, sl], prompt_mass[:, sl], layer_idx, cfg,
            model_cfg, shard_offset=c * s_loc, total_len=s, minmax=(mn, mx),
            token_valid=None if token_valid is None else token_valid[:, sl],
            prompt_lens=prompt_lens, chunk_lengths=lengths_g)
        caches.append(cache_c)
        parts.append(st_c)
    n = float(n_chunks)
    st = {}
    for key in parts[0]:
        vals = [p[key] for p in parts]
        if key in _SUMMED:
            st[key] = sum(vals)
        elif key == "importance_min":
            st[key] = torch.stack(vals).amin(dim=0)
        elif key == "importance_max":
            st[key] = torch.stack(vals).amax(dim=0)
        elif key == "importance_std":
            means = [p["importance_mean"] for p in parts]
            ex = sum(means) / n
            ex2 = sum(v_ ** 2 + m_ ** 2 for v_, m_ in zip(vals, means)) / n
            st[key] = torch.sqrt(torch.clamp(ex2 - ex ** 2, min=0.0))
        elif key == "avg_selected_importance":
            w = [p["kept_tokens"].float() for p in parts]
            st[key] = (sum(v_ * w_ for v_, w_ in zip(vals, w))
                       / torch.clamp(sum(w), min=1.0))
        else:  # means and ratios over equal-size chunks: exact
            st[key] = sum(vals) / n
    st["compression_ratio"] = st["kept_tokens"] / st["seq_len"]
    st["token_memory_savings"] = 1.0 - st["compression_ratio"]
    return concat_layer_caches(caches), st


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


def summarize_layer_stats_per_row(layer_stats: List[Dict[str, torch.Tensor]],
                                  batch: int) -> List[Dict[str, float]]:
    """Per-row summaries (a stat with one value for the batch is given to
    every row), from one [L, K, B] float32 transfer to the host."""
    if not layer_stats:
        return [{} for _ in range(batch)]
    keys = tuple(sorted(layer_stats[0].keys()))
    rows = []
    for s in layer_stats:
        vals = [torch.as_tensor(s[k]).float() for k in keys]
        rows.append(torch.stack([
            (x.reshape(-1)[:batch] if x.dim() else x).expand(batch)
            for x in vals]))
    arr = torch.stack(rows).cpu().numpy().astype(np.float32)  # [L, K, B]
    ki = {k: i for i, k in enumerate(keys)}
    return [_build_summary(arr[:, :, b], arr[:, :, b], ki, len(layer_stats))
            for b in range(batch)]
