"""Token sampling: temperature, top-k, nucleus (top-p) and min-p filtering,
and repetition / presence / frequency penalties (PyTorch).

Port of the JAX package's `ops/sampling.py`. Every filter is a mask over
the whole logits row, so nothing has a data-dependent shape and nothing is
read back to the host. The reference draws from `jax.random.categorical`,
which is argmax(logits + Gumbel noise); here the noise comes from an
explicit `torch.Generator` (other numbers than JAX's stream), and the
argmax over the filtered logits plus given noise is `_sample_with_noise`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Sampling configuration.

    temperature: 0.0 is greedy argmax (filters ignored; penalties still
      apply, processors before the argmax as in HF).
    top_k: keep the k highest logits (0: off).
    top_p: keep the smallest probability-sorted prefix whose cumulative mass
      reaches top_p (1.0: off).
    min_p: drop tokens whose probability is below min_p * the largest
      (0.0: off); applied after top_k and top_p.
    repetition_penalty: divide positive logits of tokens seen so far by r,
      multiply negative ones (1.0: off).
    presence_penalty: subtract from the logits of tokens seen at least once
      (0.0: off).
    frequency_penalty: subtract in proportion to a token's count (0.0: off).

    Penalties read per-row occurrence counts ([B, vocab] int32), which
    `decode_loop` carries across steps.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def uses_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)



def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row to NEG_INF."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: a token is kept when the probability mass sorted
    before it is below p (so the token that crosses p stays, and the
    argmax always does)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p
    cutoff = torch.where(keep_sorted, sorted_logits,
                         torch.full((), torch.inf, device=logits.device)
                         ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff, NEG_INF)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens with probability below min_p * the row's largest."""
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    thresh = min_p * probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < thresh, NEG_INF)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    params: SamplingParams) -> torch.Tensor:
    """Repetition, presence and frequency penalties from occurrence counts
    [B, V] (`update_counts`); float32 out."""
    x = logits.float()
    seen = counts > 0
    if params.repetition_penalty != 1.0:
        r = params.repetition_penalty
        x = torch.where(seen, torch.where(x > 0, x / r, x * r), x)
    if params.presence_penalty != 0.0:
        x = x - params.presence_penalty * seen
    if params.frequency_penalty != 0.0:
        x = x - params.frequency_penalty * counts.float()
    return x


def update_counts(counts: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """New occurrence counts [B, V] with tokens [B] recorded (the input is
    left as it was)."""
    idx = tokens.long()[:, None].to(counts.device)
    return counts.scatter_add(1, idx, torch.ones_like(idx, dtype=counts.dtype))


def init_counts(batch: int, vocab: int,
                tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero [B, V] int32 counts (on the tokens' device), seeded with
    `tokens` [B] when given."""
    counts = torch.zeros((batch, vocab), dtype=torch.int32,
                         device=None if tokens is None else tokens.device)
    return counts if tokens is None else update_counts(counts, tokens)


def _sample_with_noise(logits: torch.Tensor, g: torch.Tensor,
                       params: SamplingParams) -> torch.Tensor:
    """Next tokens [B] from (penalised) logits [B, V] and Gumbel noise g of
    the same shape: temperature, the filters, then argmax(x + g), which is
    what `jax.random.categorical` computes from its own noise."""
    x = logits.float() / params.temperature
    x = apply_top_k(x, params.top_k)
    x = apply_top_p(x, params.top_p)
    x = apply_min_p(x, params.min_p)
    return torch.argmax(x + g, dim=-1)


def _gumbel_noise(shape, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), drawn
    from `generator` (float32)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator],
                  params: SamplingParams,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token ids [B] from logits [B, V] under `params`. Greedy needs no
    generator; `counts` ([B, V]) turns the penalties on, in greedy mode
    too."""
    if params.uses_penalties and counts is not None:
        logits = apply_penalties(logits, counts, params)
    if params.is_greedy:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    g = _gumbel_noise(logits.shape, generator, device=logits.device)
    return _sample_with_noise(logits, g, params)
