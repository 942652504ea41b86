"""Sequence-parallel (ring) prefill attention with the exact prompt-mass
side channel, over a process group of sequence shards.

Port of the JAX package's `parallel/ring_attention.py`. Rank i of n holds
the i-th block of S/n queries and keys of the global sequence (global
offset i * S/n). K/V blocks travel around the ring (`comm.ring_shift`, JAX's
`ppermute`), and each (query block, key block) pair runs K1
(`ops/cuda/flash_prefill.py`):

- t = 0, the diagonal pair: `flash_diagonal_pair_attention`, K1's causal
  mode with the log-sum-exp output, at the block's local prompt length;
- t > 0, a key block from rank i - t (mod n): wholly in the past when it
  starts before the query block, then K1 mode (c),
  `flash_full_pair_attention`; wholly in the future otherwise, then no
  launch and no partial (JAX's `lax.cond` returns neutral statistics,
  whose weight in the merge is 0).

The partials merge exactly by log-sum-exp (`merge_attention_partials`),
the per-head prompt mass in the same rescale, so the merged mass, and so
scoring, selection and the compressed caches, equal the one-device
computation's up to float association. Skipping is decided on the host
(the offsets are host ints); the ring's send and receive run on every rank
at every step, since a rank that skipped one would leave its neighbours
waiting. CPU tensors run the plain pair (`pair_attention_plain`), CUDA
tensors the kernels. `block_q` and `block_k` name K1's tile as JAX's do
(both pairs take the same; `flash_prefill.resolve_tile` checks them, also
where the plain pair runs); JAX's `interpret` has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.cuda.flash_prefill import (_CAUSAL, _FULL,
                                      flash_diagonal_pair_attention,
                                      flash_full_pair_attention,
                                      merge_attention_partials,
                                      pair_attention_plain, resolve_tile)
from .. import comm


def ring_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prompt_len: int,
    group,
    prompt_lens: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention + prompt mass with the sequence sharded over
    `group` (None: one rank).

    q: [B, S_loc, H_q, D] this rank's queries, RoPE'd at global positions;
    k, v: [B, S_loc, H_kv, D] its keys and values. prompt_len: the global
    prompt length; prompt_lens: optional [B] per-row prompt lengths (ragged
    rows, right-padded: padding keys lie after every real query, so
    causality hides them, and padding query rows give values the caller
    masks). use_flash (None: on CUDA tensors) runs K1's pair kernels, else
    their plain version. block_q / block_k: the pairs' K1 tile.
    Returns (out [B, S_loc, H_q, D] in q's dtype, prompt_mass [B, S_loc]
    float32 averaged over heads): this rank's rows of the global result.
    """
    if use_flash is None:
        use_flash = q.is_cuda
    tile = {"block_q": block_q, "block_k": block_k}
    for mode in (_CAUSAL, _FULL):
        resolve_tile(mode, q.shape[3], q.shape[1], k.shape[1], **tile)
    if use_flash:
        diagonal = lambda *a: flash_diagonal_pair_attention(  # noqa: E731
            *a, **tile)
        full = lambda *a: flash_full_pair_attention(*a, **tile)  # noqa
    else:
        diagonal = lambda *a: pair_attention_plain(*a, causal=True)  # noqa
        full = lambda *a: pair_attention_plain(*a, causal=False)  # noqa
    rank, n = comm.rank_and_size(group)
    s_loc = q.shape[1]
    q_off = rank * s_loc
    plen_g = prompt_len if prompt_lens is None else prompt_lens.to(q.device)

    def plen_local(k_off: int):
        if prompt_lens is None:
            return min(max(prompt_len - k_off, 0), s_loc)
        return torch.clamp(plen_g - k_off, 0, s_loc)

    parts = [diagonal(q, k, v, plen_local(q_off))]
    kv = torch.stack([k, v])
    for t in range(1, n):
        kv = comm.ring_shift(kv, group)
        k_off = (rank - t) % n * s_loc
        if k_off < q_off:
            parts.append(full(q, kv[0], kv[1], plen_local(k_off)))
    out, pm = merge_attention_partials(parts)
    return out.to(q.dtype), pm.mean(dim=1)
