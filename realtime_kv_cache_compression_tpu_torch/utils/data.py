"""Prompt helpers of the JAX package's `utils/data.py` that serving needs
(`truncate_middle`); the dataset loaders wait for the port of eval."""

from __future__ import annotations

from typing import List


def truncate_middle(token_ids: List[int], max_length: int) -> List[int]:
    """Budget-exceeding contexts keep head + tail, dropping the middle
    (data_utils.py:154-168 policy — preserves instructions at the start and
    the question at the end)."""
    if len(token_ids) <= max_length:
        return list(token_ids)
    half = max_length // 2
    return (list(token_ids[:half])
            + list(token_ids[len(token_ids) - (max_length - half):]))
