"""Collectives over a `torch.distributed` process group, in one place.

The JAX package runs its parallel axes as `shard_map` over one process's
devices and calls `psum`, `pmax`, `pmin`, `all_gather(tiled=True)` and
`ppermute` inside it. The port runs one process per rank, and every
collective it issues goes through this module:

- `all_reduce_sum`, `all_reduce_max`: `psum`, `pmax` (a new tensor; the
  input is left as it is; `pmin` is a MAX of the negated values);
- `all_gather`: `all_gather(tiled=True)` along an axis;
- `all_gather_tensors`: several tensors of any dtypes from every rank in
  one collective (their bytes packed into one buffer);
- `ring_shift`: the ring's `ppermute`, rank r sends to r + 1 and receives
  from r - 1 (mod n);
- `neighbour_shift`: the pool halo's open-ended `ppermute`, each rank
  sends to one neighbour and the rank at the end receives zeros;
- `send_to`, `recv_from`: one point-to-point hop (the pipeline's
  activations and their gradients, stage to stage);
- `broadcast`: one rank's tensor on every rank (the pipeline's tokens).

Three of them have differentiable forms for training over a sharded tree,
the usual tensor-parallel pairs (autograd Functions; with no gradient
wanted they are the plain collectives):

- `reduce_sum`: all-reduce SUM forward, identity backward (a row-parallel
  product's partial sums, the masked embedding lookup, a data rank's loss
  sum);
- `enter_split`: identity forward, all-reduce SUM of the gradient backward
  (the input of column-parallel products: each rank's products give part
  of its gradient);
- `gather_split`: all-gather forward, this rank's slice of the gradient
  backward (the vocab-split logits).

`group=None` is a group of one rank: every collective returns its input
(a copy where the contract gives a new tensor) and issues nothing.

On a gloo group a CUDA tensor is staged through host memory: copied to
the host, exchanged, copied back to its device (one H100 serves every rank
of the smoke, and NCCL refuses two ranks on one device). On any other
backend (NCCL) CUDA tensors pass straight through. `stage.seconds`,
`stage.bytes` and `stage.calls` count the host copies (the device work
queued before a copy is waited for outside the count). Data moves as raw
bytes wherever no arithmetic touches it (gathers, sends), so bf16 and bool
tensors cross bit for bit whatever the backend supports; reductions take
float32, float64 or int64 tensors.

Every rank of a group must issue the same collectives in the same order:
callers never skip one on a rank, even where that rank has nothing to
contribute (it sends zeros or an unused block instead).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_REDUCIBLE = (torch.float32, torch.float64, torch.int64)


def rank_and_size(group) -> Tuple[int, int]:
    """(this rank's index in `group`, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def stage(t: torch.Tensor, to) -> torch.Tensor:
    """`t` copied to device `to`, counted in stage.seconds / bytes / calls.
    A copy off a CUDA device first waits (uncounted) for the work queued
    before it."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    out = t.to(to)
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    stage.seconds += time.perf_counter() - t0
    stage.bytes += t.numel() * t.element_size()
    stage.calls += 1
    return out


stage.seconds, stage.bytes, stage.calls = 0.0, 0, 0


def reset_stage_counts() -> None:
    stage.seconds, stage.bytes, stage.calls = 0.0, 0, 0


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of t's elements (a contiguous copy if needed)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.view(like.dtype).reshape(like.shape)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if t.dtype not in _REDUCIBLE:
        raise TypeError(f"all-reduce takes {_REDUCIBLE}, got {t.dtype}")
    if group is None:
        return t.clone()
    staged = _staged(group, t)
    buf = stage(t, "cpu") if staged else t.clone()
    dist.all_reduce(buf, op=op, group=group)
    return stage(buf, t.device) if staged else buf


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """psum: the elementwise sum of `t` over the group's ranks."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """pmax: the elementwise maximum of `t` over the group's ranks."""
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def all_gather_tensors(tensors: Sequence[torch.Tensor], group
                       ) -> List[List[torch.Tensor]]:
    """Every rank's `tensors`, in rank order: out[r][i] is rank r's
    tensors[i] (a tensor of its own). Every rank passes the same shapes
    and dtypes; all of them travel as one byte buffer in one collective."""
    if group is None:
        return [[t.clone() for t in tensors]]
    _, n = rank_and_size(group)
    dev = tensors[0].device
    flat = torch.cat([_as_bytes(t.to(dev)) for t in tensors])
    staged = _staged(group, flat)
    buf = stage(flat, "cpu") if staged else flat
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = []
    for part in parts:
        part = stage(part, dev) if staged else part
        sizes = [t.numel() * t.element_size() for t in tensors]
        # Each tensor's bytes copied out first: a view of another dtype
        # needs its offset aligned to that dtype's size.
        out.append([_from_bytes(b.clone(), t) for b, t in
                    zip(torch.split(part, sizes), tensors)])
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """all_gather(tiled=True): every rank's `t` concatenated along `dim` in
    rank order."""
    return torch.cat([p[0] for p in all_gather_tensors([t], group)],
                     dim=dim)


def _exchange(t: torch.Tensor, dst: Optional[int], src: Optional[int],
              group) -> Optional[torch.Tensor]:
    """Sends t to group rank dst and receives a tensor like t from group
    rank src (either may be None), as one batch of point-to-point
    operations; returns what was received (None without src)."""
    staged = _staged(group, t)
    send = _as_bytes(stage(t, "cpu") if staged else t)
    recv = torch.empty_like(send) if src is not None else None
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is None:
        return None
    out = _from_bytes(recv, t)
    return stage(out, t.device) if staged else out


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """ppermute i -> i + 1 (mod n): rank r's result is rank r - 1's `t`."""
    r, n = rank_and_size(group)
    if n == 1:
        return t.clone()
    return _exchange(t, (r + 1) % n, (r - 1) % n, group)


def neighbour_shift(t: torch.Tensor, step: int, group) -> torch.Tensor:
    """ppermute i -> i + step (step = +1 or -1) without wrapping: rank r's
    result is rank r - step's `t`; the rank with no such neighbour gets
    zeros, and the rank with no receiver sends nothing."""
    if step not in (1, -1):
        raise ValueError(f"neighbour_shift: step must be +1 or -1, got "
                         f"{step}")
    r, n = rank_and_size(group)
    dst = r + step if 0 <= r + step < n else None
    src = r - step if 0 <= r - step < n else None
    got = None if n == 1 else _exchange(t, dst, src, group)
    return torch.zeros_like(t) if got is None else got


def send_to(t: torch.Tensor, dst: int, group) -> None:
    """Sends `t` to group rank `dst`, which takes it with `recv_from`."""
    _exchange(t, dst, None, group)


def recv_from(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """The tensor that group rank `src` sends with `send_to`; `like` gives
    its shape, dtype and device (its values are not read)."""
    return _exchange(like, None, src, group)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank `src`'s `t` on every rank of the group, as a new tensor.
    Every rank passes a tensor of the same shape and dtype (only `src`'s
    values are read)."""
    if group is None:
        return t.clone()
    staged = _staged(group, t)
    buf = _as_bytes(stage(t, "cpu") if staged else t).clone()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    out = _from_bytes(buf, t)
    return stage(out, t.device) if staged else out


def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.float(), ctx.group).to(grad.dtype), None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.start = rank_and_size(group)[0] * t.shape[dim]
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None, None


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce_sum` whose gradient passes through unchanged: every rank
    holds the same gradient of the sum, which is each partial's."""
    if group is None or not _wants_grad(t):
        return all_reduce_sum(t, group)
    return _ReduceSum.apply(t, group)


def enter_split(t: torch.Tensor, group) -> torch.Tensor:
    """`t` as it is, whose gradient is summed over `group` in the backward:
    the input of products split over the group's ranks."""
    if group is None or not _wants_grad(t):
        return t
    return _EnterSplit.apply(t, group)


def gather_split(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`all_gather` whose gradient is this rank's slice of the gathered
    tensor's."""
    if group is None or not _wants_grad(t):
        return all_gather(t, dim, group)
    return _GatherSplit.apply(t, dim, group)
