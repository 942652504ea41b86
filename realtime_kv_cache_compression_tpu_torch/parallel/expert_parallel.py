"""Capacity-routed expert parallelism over the mesh's `model` axis.

Port of the JAX package's `parallel/expert_parallel.py`, where a
`shard_map` runs the body on every device of the axis; here every rank of
the axis runs it on its own slice. Expert weights are sharded on their
[E] axis ([E, H, I] → [E/P, H, I] a rank, `sharding.shard_params`);
tokens are the same on every rank of the axis, as they are between the
tensor-parallel layers. Each rank:

1. routes all tokens with the replicated router (`ops/moe.router_topk`),
   so every rank makes the same decisions with no communication;
2. keeps up to `capacity` token-slot rows for its local experts, by a
   stable sort that puts local rows first, grouped by expert (PyTorch's
   stable `argsort` stands for `jnp.argsort`, so a small capacity drops
   the same rows as JAX's);
3. runs the grouped FFN over those rows (one product per local expert
   over its contiguous group, as `ops/moe.py`'s ragged strategy; the group
   sizes are read to the host once per call);
4. scatter-adds its weighted outputs back to token order, and one float32
   SUM all-reduce over the axis is the combine (no all-to-all: the tokens
   are already everywhere).
Under a gradient (training over a sharded tree) the input enters through
`comm.enter_split` and the combine is `comm.reduce_sum`: the router's
gradient on a rank covers its own experts' rows only, and
`ShardLayout.sync_grads` sums it over the axis.

Rows past capacity are dropped (standard MoE overflow);
`capacity_factor=None` sizes the capacity at N·k, which drops nothing and
equals the one-rank MoE MLP.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import comm
from ..ops.moe import _act, router_topk
from .mesh import MODEL_AXIS, Mesh


def _grouped(xs: torch.Tensor, w: torch.Tensor, sizes) -> torch.Tensor:
    """`jax.lax.ragged_dot`: rows of xs in contiguous groups of `sizes`,
    group e times w[e]; rows past the groups give zeros."""
    out = torch.zeros((xs.shape[0], w.shape[-1]), dtype=xs.dtype,
                      device=xs.device)
    start = 0
    for e, size in enumerate(sizes):
        if size:
            out[start:start + size] = xs[start:start + size] @ w[e].to(
                xs.dtype)
        start += size
    return out


def _local_moe(moe: Dict[str, torch.Tensor], x2: torch.Tensor, cfg,
               capacity: int, rank: int) -> torch.Tensor:
    """One rank's share: its experts' outputs for the rows it keeps,
    weighted and added back to token order in float32 ([N, H])."""
    n, h = x2.shape
    k = cfg.num_experts_per_tok
    e_local = moe["w_gate"].shape[0]
    base = rank * e_local

    w, ids = router_topk(x2, moe["gate"], k)           # replicated routing
    flat_ids = ids.reshape(-1).long()                  # [N*k]
    flat_w = w.reshape(-1)
    token_of = torch.arange(n * k, device=x2.device) // k
    local = (flat_ids >= base) & (flat_ids < base + e_local)
    # Local rows first, grouped by local expert; the others sort to the
    # back (key e_local) and fall off the capacity window.
    local_e = torch.where(local, flat_ids - base,
                          torch.full_like(flat_ids, e_local))
    keep = torch.argsort(local_e, stable=True)[:capacity]
    keep_e = local_e[keep]
    keep_valid = keep_e < e_local
    xs = torch.where(keep_valid[:, None], x2[token_of[keep]],
                     torch.zeros((), dtype=x2.dtype, device=x2.device))
    sizes = torch.bincount(keep_e, minlength=e_local + 1)[:e_local].tolist()

    h1 = _grouped(xs, moe["w_gate"], sizes)
    h2 = _grouped(xs, moe["w_up"], sizes)
    ys = _grouped(_act(h1, cfg.hidden_act) * h2, moe["w_down"], sizes)

    weight = torch.where(keep_valid, flat_w[keep],
                         torch.zeros((), device=x2.device)).to(ys.dtype)
    out = torch.zeros((n, h), dtype=torch.float32, device=x2.device)
    out.index_add_(0, token_of[keep], (ys * weight[:, None]).float())
    return out


def ep_moe_mlp(moe: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
               mesh: Mesh, capacity_factor: Optional[float] = None,
               axis: str = MODEL_AXIS) -> torch.Tensor:
    """Expert-parallel MoE MLP.

    moe: this rank's expert slice ([E/P, ...] stacks of raw weights, as
    `shard_params` leaves them) and the replicated router `gate` [H, E];
    x: [..., H] hidden states, the same on every rank of `axis`.
    capacity_factor: the per-rank row budget as a multiple of the balanced
    load N·k/P; None gives capacity N·k (lossless). Returns [..., H] in
    x's dtype, the same on every rank of the axis."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    n = x2.shape[0]
    k = cfg.num_experts_per_tok
    p = mesh.shape[axis]
    if capacity_factor is None:
        capacity = n * k
    else:
        capacity = min(n * k, int(-(-n * k * capacity_factor // p)))
    group = mesh.group(axis)
    # Differentiable: each rank's routing and experts give part of x's
    # gradient (summed over the axis), and the combine's gradient reaches
    # every rank's rows as it is.
    out = _local_moe(moe, comm.enter_split(x2, group), cfg, capacity,
                     mesh.coords[axis])
    out = comm.reduce_sum(out, group)
    return out.reshape(shape).to(x.dtype)
