"""Evaluation: text metrics, the LongBench harness and the benchmark suite
(the JAX package's `eval/`, whose `__init__` imports JAX, so the port keeps
its own)."""

from . import metrics  # noqa: F401
from .longbench import LongBenchEvaluator, ModelRunner, pick_bucket

__all__ = ["metrics", "LongBenchEvaluator", "ModelRunner", "pick_bucket"]
