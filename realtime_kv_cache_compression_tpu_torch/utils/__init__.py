"""Framework-free helpers (tokenizer, prompt truncation); imports no JAX."""

from . import data, tokenizer  # noqa: F401
