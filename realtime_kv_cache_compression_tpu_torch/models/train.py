"""Minimal LM training step (next-token cross-entropy + AdamW).

Port of the JAX package's `models/train.py`, which trains with optax. The
port is stateful: `make_optimizer` binds an optimizer to a params tree
(and marks its tensors as requiring grad), and `train_step` updates that
tree in place and returns the loss. The update is optax's
`chain(clip_by_global_norm(clip_norm), adamw(lr, weight_decay))`:

- the clip scales every gradient by clip_norm / ‖g‖ only where the global
  norm ‖g‖ >= clip_norm (as optax does, on the device, with no host read;
  `torch.nn.utils.clip_grad_norm_` would add 1e-6 to the norm);
- `torch.optim.AdamW` with b1 0.9, b2 0.999, eps 1e-8 and decay on every
  tensor is optax's `adamw` update;
- with `total_steps`, the learning rate follows optax's
  `warmup_cosine_decay_schedule(0, lr, max(int(total * warmup_frac), 1),
  total, lr * 0.01)`, taken at the update count before the increment (so
  the first update runs at lr 0).

Nothing here launches a kernel of the port's: `forward_logits` attends
through `scaled_dot_product_attention` on CUDA inputs (its backward is
PyTorch's), through the plain attention elsewhere.

Over a (data, model) mesh (a tree cut by `parallel.shard_params`; ids and
mask stay global, as in JAX): each data rank's loss covers its own rows
(`ShardLayout.rows`) through the differentiable sharded forward
(`llama.forward_rows`), and the loss is the global mean, its sum and its
count each summed over `data`. After the backward the gradients are
summed over `data` (and a leaf that several model ranks use in part over
`model`: `ShardLayout.sync_grads`); the clip takes the whole model's norm
(`ShardLayout.grad_norm_of`), and AdamW updates each rank's slice in
place, the replicated tensors alike on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import comm
from ..config import ModelConfig
from .llama import forward_logits, forward_rows

Params = Dict[str, Any]


def token_nll(logits: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy per target position, [B, S-1] float32, of
    logits [B, S, V] over input_ids [B, S] (`lm_loss`, and a pipeline's
    last stage per microbatch)."""
    logp = torch.log_softmax(logits.float()[:, :-1], dim=-1)
    return -torch.gather(logp, -1, input_ids[:, 1:, None].long())[..., 0]


def lm_loss(params: Params, input_ids: torch.Tensor, cfg: ModelConfig,
            use_flash: Optional[bool] = None,
            loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy.

    loss_mask: optional [B, S-1] per-TARGET-position weights (aligned to
    input_ids[:, 1:]). SFT-style masking — at long contexts an unmasked
    mean is dominated by unpredictable filler and the supervised span's
    gradient share collapses with 1/S. None → plain mean over all
    positions. Under a sharded tree the global mean (see the module's
    docstring), the same on every rank.
    """
    layout = getattr(params, "layout", None)
    if layout is None:
        nll = token_nll(forward_logits(params, input_ids, cfg,
                                       use_flash=use_flash), input_ids)
        if loss_mask is not None:
            w = loss_mask.to(nll.dtype)
            return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        return nll.mean()
    ids = layout.rows(input_ids)
    nll = token_nll(forward_rows(params, ids, cfg, use_flash=use_flash), ids)
    if loss_mask is not None:
        w = layout.rows(loss_mask).to(nll.dtype)
        total, count = (nll * w).sum(), w.sum()
    else:
        total = nll.sum()
        count = torch.tensor(float(nll.numel()), device=nll.device)
    total = comm.reduce_sum(total[None], layout.data_group)[0]
    count = comm.all_reduce_sum(count[None].float(), layout.data_group)[0]
    if loss_mask is not None:
        count = torch.clamp(count, min=1.0)
    return total / count


def warmup_cosine_decay(lr: float, total_steps: int,
                        warmup_frac: float = 0.05) -> Callable[[int], float]:
    """optax's warmup_cosine_decay_schedule(0, lr, warmup, total_steps,
    lr * 0.01) with warmup = max(int(total_steps * warmup_frac), 1): a
    linear ramp from 0 over `warmup` updates, then a cosine decay to lr *
    0.01 at `total_steps`, held after it."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"total_steps ({total_steps}) must exceed the "
                         f"warmup ({warmup})")
    alpha = lr * 0.01 / lr

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1 - min(max(count, 0), warmup) / warmup
            return -lr * frac + lr
        c = min(count - warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


def _param_tensors(params) -> List[torch.Tensor]:
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _param_tensors(v)]
    if not isinstance(params, torch.Tensor):
        raise TypeError(f"only raw tensors train, not a "
                        f"{type(params).__name__}")
    return [params]


class Optimizer:
    """Global-norm clip + AdamW (+ schedule) over the tensors of a params
    tree, updating them in place. `count` is the number of updates made;
    `last_grad_norm` the global gradient norm of the last one (a device
    scalar, before clipping)."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 schedule: Optional[Callable[[int], float]],
                 clip_norm: float):
        self.tensors = _param_tensors(params)
        for t in self.tensors:
            t.requires_grad_(True)
        self.lr = lr
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.adamw = torch.optim.AdamW(self.tensors, lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def lr_at(self, count: int) -> float:
        return self.schedule(count) if self.schedule else self.lr

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _clip(self, norm_of=None) -> None:
        grads = [t.grad for t in self.tensors]
        norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32))
        norm = (torch.linalg.vector_norm(norms) if norm_of is None
                else norm_of(norms))
        self.last_grad_norm = norm
        keep = norm < self.clip_norm
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm),
                          torch.full_like(norm, self.clip_norm))
        torch._foreach_div_(grads, div)  # (g / ‖g‖) * clip_norm, as optax
        torch._foreach_mul_(grads, mul)  # orders it

    def step(self, norm_of: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]] = None) -> None:
        """One update from the gradients in `.grad`. `norm_of` maps the
        per-tensor gradient norms [n] (float32) to the global norm that the
        clip takes; by default their 2-norm (a pipeline stage's sums the
        squares over its stages: `parallel/pipeline.py`)."""
        with torch.no_grad():
            self._clip(norm_of)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adamw.step()
        self.count += 1

    def release(self) -> None:
        """Stop tracking gradients: the tree is then used for inference
        alone."""
        self.zero_grad()
        for t in self.tensors:
            t.requires_grad_(False)


def make_optimizer(params: Params, lr: float = 1e-4,
                   weight_decay: float = 0.01,
                   total_steps: Optional[int] = None,
                   warmup_frac: float = 0.05,
                   clip_norm: float = 1.0) -> Optimizer:
    """AdamW with global-norm clipping over `params` (its tensors then
    require grad); pass `total_steps` for a linear warmup + cosine decay
    schedule.

    The constant-lr form destabilizes the quality-demo recall trainings
    (loss bounced 0.03 -> 1.5 across steps at lr 3e-3, round-4 needle
    runs); warmup+cosine with clip 1.0 is the boring fix.
    """
    schedule = (warmup_cosine_decay(lr, total_steps, warmup_frac)
                if total_steps else None)
    return Optimizer(params, lr, weight_decay, schedule, clip_norm)


def train_step(params: Params, optimizer: Optimizer,
               input_ids: torch.Tensor, cfg: ModelConfig,
               use_flash: Optional[bool] = None,
               loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One training step: the loss and its gradients, then the optimizer's
    update of `params` in place. Returns the loss (a device scalar, not
    read to the host). Under a sharded tree (`optimizer` made on it) every
    rank calls it with the same global ids and mask."""
    optimizer.zero_grad()
    loss = lm_loss(params, input_ids, cfg, use_flash, loss_mask)
    loss.backward()
    layout = getattr(params, "layout", None)
    norm_of = None
    if layout is not None:
        kinds = layout.leaf_kinds(params)
        layout.sync_grads(optimizer.tensors, kinds)
        norm_of = layout.grad_norm_of(kinds)
    optimizer.step(norm_of)
    return loss.detach()
