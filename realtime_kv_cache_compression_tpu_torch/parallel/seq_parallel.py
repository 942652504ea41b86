"""Sequence-parallel compressed prefill: the whole model forward with the
prompt's sequence axis sharded over a process group.

Port of the JAX package's `parallel/seq_parallel.py`, one process per
rank where JAX runs `shard_map` over one process's devices. Every rank
calls `seq_parallel_prefill` with the same full `input_ids` and the group,
and takes its own S/n tokens: the residual stream stays sharded [B, S/n,
hidden]; attention is ring attention with the exact prompt-mass side
channel (`parallel/ring_attention.py`: K1's diagonal pair and mode (c));
only compression sees more than S/n tokens, and in the replicated mode
only one layer's K/V at a time. In the fully sharded mode
(`sharded_compression=True`) no rank ever holds more than its own tokens:
each keeps the slot shard of every layer's caches. `models/llama`'s
`decode_step` / `decode_loop` decode that state as it is, with
`slot_group=group`: each rank runs K2 in its lse mode over its own tier
shard (rank 0 adds the ring and decode pool, which every rank holds
alike), and `merge_slot_partials` merges the ranks' partials exactly.
`gather_sharded_state` still assembles the full chunk-packed state (the
reference that sharded decode is held to). No rank materialises S x S
attention, and activation memory is S/n a rank.

Collectives (`comm.py`), per layer: n - 1 ring shifts of the
layer's K/V block; one SUM all-reduce assembling the query window and one
MAX and one SUM in its mass (query-guided scoring), plus two halo
exchanges with a pooled mass; then in the replicated mode two all-gathers
(K/V, then the masses), in the sharded one a MAX all-reduce of the mass
ranges, a SUM of the valid counts on ragged rows and three for the stats.
After the layers, one SUM all-reduce gives every rank each row's last
hidden state. A decode step from the sharded state issues one
collective a layer: the all-gather of the ranks' (o, lse) partials in
`merge_slot_partials`; the tiers never move.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import comm
from ..compression.compressor import (_TIER_FIELDS, compress_layer_kv,
                                      concat_layer_caches)
from ..compression.kv_cache import CompressedLayerCache, TierCache
from ..config import CompressionConfig, ModelConfig
from ..models import llama
from ..ops.attention import sharded_window_attention_mass
from ..ops.cuda.flash_prefill import merge_attention_partials
from .mesh import Mesh, grid_mesh, world_size
from .ring_attention import ring_prefill_attention

SEQ_AXIS = "seq"


def create_seq_mesh(n: Optional[int] = None) -> Mesh:
    """A 1-axis mesh of the world's ranks carrying the prefill sequence;
    `mesh.group(SEQ_AXIS)` is the group to pass to `seq_parallel_prefill`.
    n (default: the world size) must be the world size."""
    n = world_size() if n is None else n
    return grid_mesh((SEQ_AXIS,), (n,))


def _window_queries(q, q_off: int, win_start, w_win: int, group):
    """The observation window's queries [B, W, H_q, D] on every rank: each
    rank fills the window slots whose global position it holds (zeros
    elsewhere) and one SUM all-reduce assembles them (each slot is
    nonzero on one rank at most, so the float32 sum is exact)."""
    b, s_loc = q.shape[:2]
    slot_pos = win_start + torch.arange(w_win, device=q.device)[None]
    local = slot_pos - q_off                                  # [B, W]
    here = (local >= 0) & (local < s_loc)
    idx = torch.clamp(local, 0, s_loc - 1).long()
    rows = torch.gather(q, 1, idx[:, :, None, None].expand(
        b, w_win, *q.shape[2:])).float()
    rows = torch.where(here[:, :, None, None], rows,
                       torch.zeros((), device=q.device))
    return comm.all_reduce_sum(rows, group).to(q.dtype), slot_pos


def seq_parallel_prefill(
    params: llama.Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    group,
    max_decode_len: int = 128,
    sharded_compression: bool = False,
    lengths: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, llama.DecodeState, List[Dict[str, torch.Tensor]]]:
    """Compressed prefill with the sequence sharded over `group` (None:
    one rank), called by every rank with the same arguments.

    input_ids: [B, S], the whole prompt (each rank embeds its own S/n
    tokens at their global positions); S must be a multiple of the group
    size. The logits and the replicated mode's caches and stats equal
    `models.llama.prefill_compressed`'s up to float association in the
    merged prompt mass (which can swap near-tied tokens across a tier
    boundary). lengths: optional [B] true lengths of right-padded ragged
    rows: scores use the global lengths, the window and the logits sit at
    each row's true end, padding is never stored. With
    `importance_source` "query" or "both" the observation window is the
    last W global query rows (`sharded_window_attention_mass`).

    sharded_compression=True compresses fully sharded: each rank scores
    its own tokens against the exact global mass range, selects locally
    with the budget split evenly and keeps its slot shard of the caches,
    the policy and caches of `compress_layer_kv_chunked(n_chunks=n)`; the
    stats come back aggregated (the same on every rank). It raises
    ValueError if a tier would have no capacity at S/n tokens a rank.
    Decode the returned state with `slot_group=group` (no gather), or
    pass it through `gather_sharded_state` first.
    The ring runs K1 on CUDA inputs and its plain version on CPU ones;
    block_q / block_k name its tile (`ring_prefill_attention`).
    Returns (last-position logits [B, V], DecodeState, per-layer
    stats), the same on every rank but the sharded caches.
    """
    rank, n = comm.rank_and_size(group)
    b, s = input_ids.shape
    if s % n:
        raise ValueError(f"S={s} must be a multiple of the {n} ranks")
    s_loc = s // n
    q_off = rank * s_loc
    need_qmass = ccfg.importance_source != "prompt"
    w_win = min(ccfg.query_window_for(s), s) if need_qmass else 0
    prompt_len = ccfg.prompt_length(s)
    dev = input_ids.device
    prompt_lens = None
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int32)
        prompt_lens = llama._prompt_lens(lengths, ccfg, prompt_len)
    if sharded_compression:
        for layer_idx in range(cfg.num_layers):
            caps = ccfg.tier_capacities(s_loc, layer_idx,
                                        grow_for_anchors=False)
            if any(c == 0 for c in caps):
                raise ValueError(
                    f"sharded compression: layer {layer_idx} has a "
                    f"zero-capacity tier at {s_loc} tokens a rank "
                    f"(capacities {caps}); use a longer sequence or fewer "
                    f"ranks")

    gpos_b = (q_off + torch.arange(s_loc, device=dev))[None].expand(b, s_loc)
    h = llama._embed_lookup(params["embed"], input_ids[:, q_off:q_off + s_loc],
                            llama.model_dtype(cfg), cfg)
    cos, sin = llama.rope_tables(gpos_b, cfg.head_dim, cfg.rope_theta,
                                 cfg.rope_scaling)
    tv_loc = None if lengths is None else gpos_b < lengths[:, None]
    tv_full = (None if lengths is None else
               torch.arange(s, device=dev)[None] < lengths[:, None])
    if need_qmass:
        win_start = (lengths[:, None] - w_win if lengths is not None else
                     torch.full((b, 1), s - w_win, device=dev))
    caches, recents, pools, all_stats = [], [], [], []
    for layer_idx, layer in enumerate(params["layers"]):
        x = llama.rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = llama._qkv(layer, x, cfg)
        q = llama.apply_rope(q, cos, sin)
        k = llama.apply_rope(k, cos, sin)
        attn, pmass = ring_prefill_attention(q, k, v, prompt_len, group,
                                             prompt_lens=prompt_lens,
                                             use_flash=input_ids.is_cuda,
                                             block_q=block_q,
                                             block_k=block_k)
        qmass = None
        if need_qmass:
            q_w, q_pos = _window_queries(q, q_off, win_start, w_win, group)
            row_ok = q_pos >= 0
            qmass = sharded_window_attention_mass(
                q_w, torch.clamp(q_pos, 0, s - 1), row_ok, k, gpos_b,
                torch.ones_like(gpos_b, dtype=torch.bool) if tv_loc is None
                else tv_loc, group, pool=ccfg.query_mass_pool)
        if sharded_compression:
            cache, stats = compress_layer_kv(
                k, v, pmass, layer_idx, ccfg, cfg, token_valid=tv_loc,
                prompt_lens=prompt_lens, shard_offset=q_off, total_len=s,
                query_mass=qmass, group=group)
        else:
            # One layer's K/V (and masses) gathered, then compressed the
            # same way on every rank.
            kv = comm.all_gather(torch.stack([k, v]), 2, group)
            masses = comm.all_gather(torch.stack(
                [pmass] + ([qmass] if need_qmass else [])), 2, group)
            cache, stats = compress_layer_kv(
                kv[0], kv[1], masses[0], layer_idx, ccfg, cfg,
                token_valid=tv_full, prompt_lens=prompt_lens,
                query_mass=masses[1] if need_qmass else None)
        caches.append(cache)
        all_stats.append(stats)
        recent, pool = llama._decode_buffers(b, max_decode_len, cfg, ccfg,
                                             dev)
        recents.append(recent)
        pools.append(pool)
        h = llama._attn_out(layer, h, attn, cfg)

    # Each row's last position lies on one rank, which contributes its
    # hidden state; the others add zeros.
    last = (torch.full((b,), s - 1, device=dev) if lengths is None
            else lengths.long() - 1)
    here = (last >= q_off) & (last < q_off + s_loc)
    idx = torch.clamp(last - q_off, 0, s_loc - 1)
    cand = h[torch.arange(b, device=dev), idx].float()
    cand = torch.where(here[:, None], cand, torch.zeros((), device=dev))
    last_h = comm.all_reduce_sum(cand, group).to(h.dtype)
    logits = llama.logits_from_hidden(params, last_h, cfg)
    state = llama.DecodeState(
        caches=tuple(caches), recents=tuple(recents),
        position=llama._end_positions(b, s, lengths, dev),
        pools=tuple(pools))
    return logits, state, all_stats


def gather_sharded_state(state: llama.DecodeState,
                         group) -> llama.DecodeState:
    """The full decode state from each rank's slot shard (a
    `seq_parallel_prefill(sharded_compression=True)` state): every layer's
    tier shards gathered over the group (one collective a layer) and
    concatenated along the slot axis in rank order
    (`concat_layer_caches`), giving the chunk-packed caches that K2 reads;
    rings, decode pools and positions are the rank's own (the same on
    every rank). Every rank gets the same state."""
    caches = []
    for cache in state.caches:
        flat = [getattr(t, f) for t in cache.tiers for f in _TIER_FIELDS]
        per_rank = []
        for part in comm.all_gather_tensors(flat, group):
            tensors = iter(part)
            per_rank.append(CompressedLayerCache(tiers=tuple(
                TierCache(**{f: next(tensors) for f in _TIER_FIELDS},
                          chunk=t.chunk) for t in cache.tiers)))
        caches.append(concat_layer_caches(per_rank))
    return dataclasses.replace(state, caches=tuple(caches))


def merge_slot_partials(o: torch.Tensor, lse: torch.Tensor,
                        group) -> torch.Tensor:
    """One decode attention from every rank's partial over its own slots:
    o [B, 1, H_q, D] float32 and lse [B, H_q, 1] (K2's lse mode, or its
    plain version) gathered over `group` in one collective, then merged by
    log-sum-exp in rank order (`merge_attention_partials`), so every rank
    gets the same bits. Returns [B, 1, H_q, D] float32."""
    parts = comm.all_gather_tensors([o.float(), lse.float()], group)
    return merge_attention_partials([(p[0], p[1], None) for p in parts])[0]
