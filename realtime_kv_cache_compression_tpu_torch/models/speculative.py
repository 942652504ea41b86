"""Speculative decoding over the compressed KV cache (PyTorch).

Port of the JAX package's `models/speculative.py`. Each iteration drafts
n_draft tokens (prompt lookup by default: the tokens that followed the
latest earlier occurrence of the last bigram in the prompt), scores the
pending token and the drafts in one forward (`verify_forward`: plain
attention over the dequantized tiers, the recent ring, the decode pool and
the block itself, with the position-based causal mask), emits the
accepted prefix plus the bonus token, and commits exactly those tokens'
K/V (`commit_block`: the flushes and gated appends sequential decode
would have made). In float32 the tokens equal greedy `decode_loop`'s, and
drafts change only how many forwards it takes; in bf16 the verify forward
(plain attention over the block's rows, against K2 over one row on the
card) can take the other token at a near tie of two logits, and the
sequences part from there. `adaptive_speculative_decode` switches
between speculative and plain chunks on the tokens per forward it sees.

Host and device: the reference is one `lax.while_loop`. Here the per-row
emit count of an iteration is read to the host once (with the accepted
draft count, in one transfer): that read is the loop's exit test, and it
lets the host keep each row's ring fill (`DecodeState.ring_fill`), so the
flushes are decided without reading any other device value. The verify
forward reaches no kernel of the reference either: it stays plain torch.

State: `speculative_decode_loop` and `adaptive_speculative_decode` update
the state's rings and pools in place, as `decode_loop` does;
`extend_prefill` leaves its input state unchanged.

Over a sharded tree (`parallel.shard_params`) the tokens, prompts, keep
counts and logits are global and the state is the rank's own, as for
`decode_step`: the verify forward embeds its data block of the rows
(the masked lookup), attends over the rank's heads (its dequantized
tiers, ring, pool and the block), sums `wo` and `w_down` over `model`
(`ShardLayout.reduce`) and gathers the logits over the vocabulary and
the data axis, so every rank accepts the same drafts; `commit_block`
appends the rank's rows. The data axis must divide B (each data rank
holds whole rows).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import comm
from ..compression.compressor import dequantize_layer_cache
from ..compression.kv_cache import (append_recent, dequantize_decode_pool,
                                    flush_recent)
from ..config import CompressionConfig, ModelConfig
from ..ops.attention import attention_over_tokens
from . import llama
from .llama import (DecodeState, Params, _attn_out, _embed_lookup, _qkv,
                    apply_rope, logits_from_hidden, model_dtype, rmsnorm,
                    rope_tables)


# ---------------------------------------------------------------------------
# Drafting: prompt-lookup (n-gram) proposer
# ---------------------------------------------------------------------------

def propose_prompt_lookup(prompt_ids: torch.Tensor, prompt_lens: torch.Tensor,
                          last2: torch.Tensor, n_draft: int) -> torch.Tensor:
    """Draft `n_draft` tokens by bigram lookup in the prompt.

    Finds the latest position j of each row's prompt where (prompt[j-1],
    prompt[j]) == (last2[:, 0], last2[:, 1]) and proposes prompt[j+1 :
    j+1+n_draft]; slots past the prompt, and rows with no match, repeat
    the last token (verification rejects them: drafts change speed, never
    the tokens).

    prompt_ids: [B, S] (right-padded); prompt_lens: [B] true lengths;
    last2: [B, 2] the two most recent tokens. Returns [B, n_draft].
    """
    b, s = prompt_ids.shape
    dev = prompt_ids.device
    pos = torch.arange(s, device=dev)[None]                       # [1, S]
    prev = torch.cat([torch.zeros_like(prompt_ids[:, :1]),
                      prompt_ids[:, :-1]], dim=1)
    lens = prompt_lens[:, None]
    # A usable match has at least one continuation token in the prompt.
    match = ((prev == last2[:, 0:1]) & (prompt_ids == last2[:, 1:2])
             & (pos >= 1) & (pos + 1 < lens))                     # [B, S]
    any_match = match.any(dim=1)
    j_best = torch.argmax(torch.where(match, pos, -1), dim=1)     # [B]
    cont = (j_best[:, None] + 1
            + torch.arange(n_draft, device=dev)[None])            # [B, K]
    looked_up = torch.gather(prompt_ids, 1, torch.clamp(cont, max=s - 1))
    usable = any_match[:, None] & (cont < lens)
    return torch.where(usable, looked_up,
                       last2[:, 1:2].expand(b, n_draft).to(looked_up.dtype))


# ---------------------------------------------------------------------------
# Verify + commit
# ---------------------------------------------------------------------------

def _pooled(state: DecodeState) -> bool:
    return bool(state.pools) and state.pools[0] is not None


def verify_forward(params: Params, tokens: torch.Tensor, state: DecodeState,
                   cfg: ModelConfig, ccfg: CompressionConfig
                   ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                       torch.Tensor]]]:
    """Score T tokens in one forward over the compressed caches; the state
    is not changed.

    tokens[:, 0] is the pending last emitted token, tokens[:, 1:] the
    drafts. Attention runs over [tiers | recent ring | decode pool | the
    block itself]; the position-based mask gives exact causality inside
    the block. Returns (logits [B, T, V], per-layer [(k_blk, v_blk)] for
    `commit_block`; under a sharded tree the blocks are the rank's rows
    and kv heads, the logits global).
    """
    layout, lcfg = llama._sharded(params, cfg)
    if layout is not None:
        tokens = layout.rows(tokens)
    b, t = tokens.shape
    dev = tokens.device
    h = _embed_lookup(params["embed"], tokens, model_dtype(cfg), cfg, layout)
    q_pos = state.position[:, None] + torch.arange(t, device=dev)[None]
    cos, sin = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    pools = state.pools if _pooled(state) else (None,) * len(state.caches)
    blk_valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    blocks = []
    for layer, cache, recent, pool in zip(params["layers"], state.caches,
                                          state.recents, pools):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, lcfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        blocks.append((k, v))
        k_c, v_c, pos_c, valid_c = dequantize_layer_cache(cache, ccfg,
                                                          q.dtype)
        rec_valid = (torch.arange(recent.capacity, device=dev)[None]
                     < recent.length[:, None])
        ks, vs = [k_c.to(q.dtype), recent.k, k], [v_c.to(q.dtype), recent.v, v]
        ps = [pos_c, recent.positions, q_pos.to(recent.positions.dtype)]
        vds = [valid_c, rec_valid, blk_valid]
        if pool is not None:
            k_p, v_p, pos_p, valid_p = dequantize_decode_pool(pool, q.dtype)
            for lst, x_p in zip((ks, vs, ps, vds), (k_p, v_p, pos_p,
                                                    valid_p)):
                lst.insert(2, x_p)
        attn = attention_over_tokens(
            q, torch.cat(ks, dim=1), torch.cat(vs, dim=1),
            torch.cat(ps, dim=1), torch.cat(vds, dim=1), q_pos)
        h = _attn_out(layer, h, attn, lcfg, layout)
    logits = logits_from_hidden(params, h, cfg)
    if layout is not None:
        logits, _ = layout.gather_outputs(logits)
    return logits, blocks


def flush_full_rings(state: DecodeState, cfg: ModelConfig,
                     ccfg: CompressionConfig) -> DecodeState:
    """Flush the full recent rings into the decode pools, in place (rows
    whose ring is not full are untouched; nothing happens without pools).
    The host-side `ring_fill` says whether any row is full, so no device
    value is read. Matches sequential `decode_step`'s flush-then-attend
    order."""
    cap = state.recents[0].capacity
    if not _pooled(state) or all(f < cap for f in state.ring_fill):
        return state
    for recent, pool in zip(state.recents, state.pools):
        flush_recent(recent, pool, ccfg, cfg)
    return dataclasses.replace(state, ring_fill=tuple(
        0 if f >= cap else f for f in state.ring_fill))


def commit_block(state: DecodeState,
                 blocks: List[Tuple[torch.Tensor, torch.Tensor]],
                 keep: torch.Tensor, cfg: ModelConfig,
                 ccfg: CompressionConfig,
                 host_keep: Optional[Sequence[int]] = None,
                 layout=None) -> DecodeState:
    """Append the first keep[b] tokens of each layer's block K/V to the
    recent rings, flushing into the decode pools exactly as sequential
    steps would, and advance the positions by keep. The rings and pools
    are updated in place.

    keep: [B] int on the state's device; host_keep: the same counts on the
    host, when the caller knows them (else `keep` is read: one sync). The
    reference's order is kept: at every block position j, rows whose ring
    is full flush (also rows already past their keep), then the append
    gated by j < keep; the host replays it on `ring_fill` to decide the
    flushes. Under a sharded tree's `layout`, keep (and host_keep) are
    global and the state and blocks the rank's: it commits its data
    block of the rows.
    """
    if layout is not None:
        lo = layout.row_start(keep.shape[0])
        keep = layout.rows(keep)
        if host_keep is not None:
            host_keep = host_keep[lo:lo + keep.shape[0]]
    if host_keep is None:
        host_keep = keep.tolist()
    t = blocks[0][0].shape[1]
    cap = state.recents[0].capacity
    pooled = _pooled(state)
    fills, flushes = list(state.ring_fill), []
    for j in range(t):
        flushes.append(pooled and any(f >= cap for f in fills))
        fills = [min((0 if flushes[-1] and f >= cap else f) + (j < n), cap)
                 for f, n in zip(fills, host_keep)]
    pools = state.pools if pooled else (None,) * len(state.recents)
    steps = torch.arange(t, device=keep.device)
    gates = steps[:, None] < keep[None, :]                        # [T, B]
    positions = state.position[None, :, None] + steps[:, None, None]
    for recent, pool, (k_blk, v_blk) in zip(state.recents, pools, blocks):
        for j in range(t):
            if flushes[j]:
                flush_recent(recent, pool, ccfg, cfg)
            append_recent(recent, k_blk[:, j:j + 1], v_blk[:, j:j + 1],
                          positions[j], gate=gates[j])
    return dataclasses.replace(
        state, position=state.position + keep.to(state.position.dtype),
        ring_fill=tuple(fills))


# ---------------------------------------------------------------------------
# Prefill extension and decode loops
# ---------------------------------------------------------------------------

def extend_prefill(params: Params, state: DecodeState,
                   suffix_ids: torch.Tensor, suffix_lens: torch.Tensor,
                   cfg: ModelConfig, ccfg: CompressionConfig
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """Extend a compressed prefill with more prompt tokens (a prefix
    cache's partial hit).

    The suffix attends to [tiers | recent ring | decode pool | itself,
    causally], the approximation decode makes over a compressed prefix,
    and its K/V append to the recent ring (flushing into the decode pools
    as sequential steps would); the state needs ring headroom for it.
    `state` is not changed: the rings, pools and positions are committed
    into copies, and the tier caches are shared (nothing writes them).

    suffix_ids: [B, T] right-padded; suffix_lens: [B] true lengths (read
    to the host once; padding sits at later positions, so real queries
    never see it, and its K/V never commit). Returns (logits [B, V] at each
    row's last real suffix token, the advanced state).
    """
    logits, blocks = verify_forward(params, suffix_ids, state, cfg, ccfg)
    keep = suffix_lens.to(device=suffix_ids.device, dtype=torch.int32)
    new_state = commit_block(llama.clone_decode_state(state), blocks, keep,
                             cfg, ccfg, layout=getattr(params, "layout",
                                                       None))
    last = torch.gather(logits, 1, (keep.long() - 1)[:, None, None].expand(
        -1, 1, logits.shape[-1]))[:, 0]
    return last, new_state


Proposer = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def speculative_decode_loop(
    params: Params,
    first_token: torch.Tensor,
    state: DecodeState,
    n_steps: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    prompt_ids: torch.Tensor,
    prompt_lens: Optional[torch.Tensor] = None,
    n_draft: int = 4,
    proposer: Optional[Proposer] = None,
    prev_token: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, DecodeState, Dict]:
    """Greedy speculative decode: the tokens of `decode_loop`, in up to
    n_draft + 1 times fewer forwards. The state's rings and pools are
    updated in place.

    first_token: [B], the token taken from the prefill logits (as for
    `decode_loop`). prompt_ids / prompt_lens: the (right-padded) prompt for
    the default prompt-lookup proposer. proposer: an override, called as
    proposer(last2 [B, 2], count [B], out [B, n_steps]) -> [B, n_draft],
    where count is the number of tokens emitted so far (first_token not
    counted). prev_token: [B] the token before first_token (seeds the first
    bigram); by default the prompt's last token, right when first_token
    came from the prefill.

    Returns (tokens [B, n_steps], state, stats): `iterations` (forwards
    run), `drafted_accepted` and `draft_rate`.
    """
    b, dev = first_token.shape[0], first_token.device
    t = n_draft + 1
    if prompt_lens is None:
        prompt_lens = torch.full((b,), prompt_ids.shape[1], dtype=torch.int32,
                                 device=dev)
    if proposer is None:
        def proposer(last2, count, out):
            return propose_prompt_lookup(prompt_ids, prompt_lens, last2,
                                         n_draft)
    if prev_token is None:
        prev_token = torch.gather(prompt_ids, 1,
                                  (prompt_lens.long() - 1)[:, None])[:, 0]
    ring_cap = state.recents[0].capacity
    pooled = _pooled(state)
    layout = getattr(params, "layout", None)
    data_group = None if layout is None else layout.data_group
    last_tok, prev_tok = first_token.long(), prev_token.long()
    # Column n_steps takes the scatter's non-writes and is cut at the end.
    out = torch.zeros((b, n_steps + 1), dtype=torch.long, device=dev)
    count = torch.zeros((b,), dtype=torch.long, device=dev)
    host_count = [0] * b
    steps = torch.arange(t, device=dev)[None]
    iters = accepted = 0
    while any(c < n_steps for c in host_count):
        state = flush_full_rings(state, cfg, ccfg)
        last2 = torch.stack([prev_tok, last_tok], dim=1)
        drafts = proposer(last2, count, out[:, :n_steps]).long()
        tokens = torch.cat([last_tok[:, None], drafts], dim=1)
        logits, blocks = verify_forward(params, tokens, state, cfg, ccfg)
        greedy = torch.argmax(logits, dim=-1)                     # [B, T]

        # Accept drafts while they match the greedy verification.
        ok = drafts == greedy[:, :-1]
        n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        m = n_acc + 1                                             # emitted
        if pooled:
            # Stop at the ring's end, so flushes land at an iteration's
            # start, where sequential decode flushes them.
            # (every data rank's rows: the state holds the rank's own)
            ring_len = comm.all_gather(state.recents[0].length, 0,
                                       data_group)
            m = torch.minimum(m, ring_cap - ring_len.long())
        # Never commit past n_steps: the final state is sequential
        # decode's.
        active = count < n_steps
        m = torch.where(active, torch.minimum(m, n_steps - count),
                        torch.zeros_like(m))
        host_m, acc = torch.stack(
            [m, torch.where(active, n_acc, torch.zeros_like(n_acc))]).tolist()

        # Emitted tokens are greedy[:, :m] (accepted drafts equal their
        # verification; position m - 1 is the bonus token). The others go
        # to the spare column: clipping them to the last column could
        # overwrite the real write there.
        cols = count[:, None] + steps
        write = (steps < m[:, None]) & (cols < n_steps)
        out.scatter_(1, torch.where(write, cols, n_steps), greedy)

        state = commit_block(state, blocks, m.to(torch.int32), cfg, ccfg,
                             host_keep=host_m, layout=layout)

        new_last = torch.gather(greedy, 1,
                                torch.clamp(m - 1, min=0)[:, None])[:, 0]
        new_prev = torch.where(
            m >= 2,
            torch.gather(greedy, 1, torch.clamp(m - 2, min=0)[:, None])[:, 0],
            last_tok)
        last_tok = torch.where(active, new_last, last_tok)
        prev_tok = torch.where(active, new_prev, prev_tok)
        count = torch.clamp(count + m, max=n_steps)
        host_count = [min(c + n, n_steps) for c, n in zip(host_count, host_m)]
        iters += 1
        accepted += sum(acc)
    stats = {"iterations": iters, "drafted_accepted": accepted,
             "draft_rate": accepted / max(iters * n_draft * b, 1)}
    return out[:, :n_steps], state, stats


# ---------------------------------------------------------------------------
# Adaptive drafting: fall back to plain decode when acceptance collapses
# ---------------------------------------------------------------------------

def adaptive_speculative_decode(
    params: Params,
    first_token: torch.Tensor,
    state: DecodeState,
    n_steps: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    prompt_ids: torch.Tensor,
    prompt_lens: Optional[torch.Tensor] = None,
    n_draft: int = 4,
    chunk: int = 16,
    min_tokens_per_forward: float = 1.3,
    probe_every: int = 4,
    proposer: Optional[Proposer] = None,
) -> Tuple[torch.Tensor, DecodeState, Dict]:
    """Speculative decode that loses to plain decode by at most one probe
    chunk in `probe_every`: a host controller measures the tokens per
    forward of each chunk and switches arms. The state's rings and pools
    are updated in place.

    Decodes in chunks of `chunk` tokens: after a speculative chunk
    (`speculative_decode_loop`), tokens per forward = chunk / iterations,
    smoothed (EMA 0.5); below `min_tokens_per_forward` it switches to plain
    chunks (`decode_loop`: K2 on CUDA inputs), and it probes with one
    speculative chunk after every `probe_every` plain ones. Both arms emit
    greedy-verified tokens and commit the same cache state, so in float32
    the tokens equal `decode_loop`'s (in bf16, up to a near tie; see the
    module's docstring).

    Returns (tokens [B, n_steps], state, stats): `arms`, the per-chunk
    trace [("spec", tokens_per_forward) | ("plain", 1.0)]; `forwards`, the
    verify and decode forwards run; `draft_rate` over the speculative
    chunks; `spec_chunks` and `plain_chunks`.
    """
    b = first_token.shape[0]
    if prompt_lens is None:
        prompt_lens = torch.full((b,), prompt_ids.shape[1], dtype=torch.int32,
                                 device=first_token.device)
    prev = torch.gather(prompt_ids, 1,
                        (prompt_lens.long() - 1)[:, None])[:, 0].long()
    last = first_token.long()
    outs: List[torch.Tensor] = []
    arms: List[Tuple[str, float]] = []
    done = forwards = drafted = accepted = plain_since_probe = 0
    ema = None
    spec_on = True
    while done < n_steps:
        c = min(chunk, n_steps - done)
        if spec_on:
            out, state, st = speculative_decode_loop(
                params, last, state, c, cfg, ccfg, prompt_ids, prompt_lens,
                n_draft, proposer=proposer, prev_token=prev)
            iters = st["iterations"]
            forwards += iters
            drafted += iters * n_draft * b
            accepted += st["drafted_accepted"]
            tpf = c / max(iters, 1)
            ema = tpf if ema is None else 0.5 * ema + 0.5 * tpf
            arms.append(("spec", tpf))
            if ema < min_tokens_per_forward:
                spec_on = False
                plain_since_probe = 0
                ema = None  # forget the collapsed regime before re-probing
        else:
            out, state = llama.decode_loop(params, last, state, c, cfg, ccfg)
            forwards += c
            arms.append(("plain", 1.0))
            plain_since_probe += 1
            if plain_since_probe >= probe_every:
                spec_on = True
        done += c
        prev = out[:, -2] if c >= 2 else last
        last = out[:, -1]
        outs.append(out)
    stats = {
        "arms": arms,
        "forwards": forwards,
        "draft_rate": accepted / max(drafted, 1),
        "spec_chunks": sum(1 for a, _ in arms if a == "spec"),
        "plain_chunks": sum(1 for a, _ in arms if a == "plain"),
    }
    return torch.cat(outs, dim=1), state, stats
