"""Beam search over the compressed KV cache (PyTorch).

Port of the JAX package's `models/beam_search.py`. The prompt is
prefilled once at B rows (`prefill_compressed`: K1 on CUDA inputs); the
decode state is then expanded to B·W beam rows, and every step is one
`decode_step` over all of them (K2 on CUDA inputs), followed by the
reindexing of the beams: each step keeps the W best (parent, token) pairs
of every batch row. Finished beams are frozen: their next-token
distribution is {EOS: 0, else: NEG_INF}, so their score stops
accumulating while they keep competing for the final ranking.

Over a sharded tree (`parallel.shard_params`) every rank runs the same
search: the prefill and each `decode_step` run over the rank's heads (K1
and K2) and its data block of the rows, their logits gathered over the
vocabulary and the data axis, so the top-W and the ranking see the whole
batch, and each rank reorders the beam rows it holds. A data rank must
hold whole prompts (B a multiple of the data ranks), so that every
beam's parent lies on its own rank.

Ties: the reference takes the top W with `lax.top_k`, which puts the
lower index first among equal values (frozen beams tie across the whole
vocabulary, since s + NEG_INF rounds to NEG_INF in float32), and ranks
the beams with a stable argsort. `torch.topk` promises no order among
ties, so both are stable sorts here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..config import CompressionConfig, ModelConfig
from . import llama

NEG_INF = -1e30


def _expand_beams(state: llama.DecodeState,
                  num_beams: int) -> llama.DecodeState:
    """[B, ...] state -> [B·W, ...], each row repeated W times (row b·W +
    beam). Every tensor is a fresh copy, so the input state is untouched."""
    rep = lambda t: t.repeat_interleave(num_beams, dim=0)  # noqa: E731
    caches = tuple(dataclasses.replace(c, tiers=tuple(
        llama._map_tensors(t, rep) for t in c.tiers)) for c in state.caches)
    return dataclasses.replace(
        state, caches=caches,
        recents=tuple(llama._map_tensors(r, rep) for r in state.recents),
        pools=tuple(p if p is None else llama._map_tensors(p, rep)
                    for p in state.pools),
        position=rep(state.position),
        ring_fill=tuple(f for f in state.ring_fill for _ in range(num_beams)))


def _gather_beams(state: llama.DecodeState,
                  flat_parent: torch.Tensor) -> llama.DecodeState:
    """Reindex the beam rows by their parents' flat indices [B·W].

    Only what decode writes is gathered: the rings, the decode pools and
    the positions. The tier caches are written only by the prefill, and
    every parent lies inside its own batch row's block of W identical
    copies, so gathering them would change nothing. Every row appends one
    token a step, so all rows hold the same ring fill and `ring_fill`
    stays as it is."""
    take = lambda t: t[flat_parent]  # noqa: E731
    return dataclasses.replace(
        state,
        recents=tuple(llama._map_tensors(r, take) for r in state.recents),
        pools=tuple(p if p is None else llama._map_tensors(p, take)
                    for p in state.pools),
        position=take(state.position))


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, the lower
    index first among equal values (as `lax.top_k`)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _search(params, logits: torch.Tensor, state: llama.DecodeState,
            cfg: ModelConfig, ccfg: CompressionConfig, num_beams: int,
            max_new_tokens: int, length_penalty: float,
            eos_token_id: Optional[int], use_fused_decode: Optional[bool]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search from the prefill's last logits [B, V] and its state
    (which stays unchanged): sequences [B, W, T] and length-normalised
    scores [B, W], best first."""
    b, w, t_total, vocab = (logits.shape[0], num_beams, max_new_tokens,
                            cfg.vocab_size)
    dev = logits.device
    eos = -1 if eos_token_id is None else eos_token_id
    layout = getattr(params, "layout", None)
    # This data rank's beam rows: a block of whole prompts' beams.
    row0 = 0 if layout is None else layout.row_start(b * w)

    # First expansion: the top W distinct first tokens per batch row.
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, tokens = _top(logp, w)                                # [B, W]
    state = _expand_beams(state, w)
    seqs = torch.full((b, w, t_total), max(eos, 0), dtype=tokens.dtype,
                      device=dev)
    seqs[:, :, 0] = tokens
    finished = (tokens == eos if eos >= 0
                else torch.zeros((b, w), dtype=torch.bool, device=dev))
    batch_base = (torch.arange(b, device=dev) * w)[:, None]       # [B, 1]
    frozen = None
    if eos >= 0:  # frozen beams may only re-emit EOS, at zero added score
        # (built by a comparison: an item assignment would copy the scalar
        # from the host and wait for the card)
        frozen = torch.where(torch.arange(vocab, device=dev) == eos,
                             0.0, NEG_INF)

    for t in range(1, t_total):
        step_logits, state = llama.decode_step(
            params, tokens.reshape(b * w), state, cfg, ccfg,
            use_fused=use_fused_decode)
        logp = torch.log_softmax(step_logits.float(),
                                 dim=-1).reshape(b, w, vocab)
        if frozen is not None:
            logp = torch.where(finished[:, :, None], frozen, logp)
        total = (scores[:, :, None] + logp).reshape(b, w * vocab)
        scores, flat = _top(total, w)                             # [B, W]
        parent = flat // vocab
        tokens = flat % vocab
        flat_parent = (batch_base + parent).reshape(b * w)
        if layout is not None:
            flat_parent = layout.rows(flat_parent) - row0
        state = _gather_beams(state, flat_parent)
        seqs = torch.take_along_dim(seqs, parent[:, :, None], dim=1)
        seqs[:, :, t] = tokens
        finished = torch.take_along_dim(finished, parent, dim=1)
        if eos >= 0:
            finished = finished | (tokens == eos)

    # Length-normalised ranking; generated length = index of the first EOS
    # + 1 (or T when there is none), and EOS pads everything after it.
    if eos >= 0:
        is_eos = seqs == eos
        any_eos = is_eos.any(dim=-1)
        first = torch.argmax(is_eos.to(torch.int8), dim=-1)       # [B, W]
        lengths = torch.where(any_eos, first + 1,
                              torch.full_like(first, t_total))
        past = torch.arange(t_total, device=dev)[None, None] > first[..., None]
        seqs = torch.where(past & any_eos[..., None],
                           torch.full_like(seqs, eos), seqs)
    else:
        lengths = torch.full((b, w), t_total, device=dev)
    adj = scores / lengths.float() ** length_penalty
    order = torch.argsort(-adj, dim=-1, stable=True)              # best first
    seqs = torch.take_along_dim(seqs, order[:, :, None], dim=1)
    return seqs, torch.take_along_dim(adj, order, dim=1)


def beam_search(
    params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    num_beams: int = 4,
    max_new_tokens: int = 32,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
    use_flash: Optional[bool] = None,
    use_fused_decode: Optional[bool] = None,
    return_all_beams: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Beam-search generation with compressed KV.

    num_beams: beam width W. length_penalty: the final ranking uses score /
    len**length_penalty (len = generated tokens up to and including EOS);
    1.0 is the average log-probability, 0.0 the raw sum. eos_token_id:
    beams that emit it freeze, and the positions after their first EOS are
    padded with it. use_flash / use_fused_decode: None runs K1 / K2 on CUDA
    inputs, as `prefill_compressed` and `decode_step` do.

    Returns (sequences [B, T], scores [B] length-normalised log-probs,
    per-layer prefill stats); with `return_all_beams`, [B, W, T] and
    [B, W], best first. Under a sharded tree every rank gets the same
    results; raises ValueError where the data axis does not divide B
    (it would split one prompt's beams over data ranks).
    """
    layout = getattr(params, "layout", None)
    if layout is not None and input_ids.shape[0] % layout.data_size:
        raise ValueError(
            f"beam_search over {layout.data_size} data ranks needs whole "
            f"prompts on each data rank: batch {input_ids.shape[0]} is not "
            f"a multiple of the data ranks, so one prompt's beams would be "
            f"split over ranks")
    logits, state, stats = llama.prefill_compressed(
        params, input_ids, cfg, ccfg, max_decode_len=max_new_tokens,
        use_flash=use_flash)
    seqs, adj = _search(params, logits, state, cfg, ccfg, num_beams,
                        max_new_tokens, length_penalty, eos_token_id,
                        use_fused_decode)
    if return_all_beams:
        return seqs, adj, stats
    return seqs[:, 0], adj[:, 0], stats
