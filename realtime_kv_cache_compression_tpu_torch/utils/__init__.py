"""Utilities: data loading and prompts, the tokenizer, timing, memory,
profiling and logging (the JAX package's `utils/`, which imports JAX, so
the port keeps its own)."""

from . import data, memory, profiling, timing, tokenizer  # noqa: F401
from .logging_utils import setup_logging  # noqa: F401
