"""PyTorch port of the real-time KV-cache compression framework.

A second package beside the JAX one (`realtime_kv_cache_compression_tpu`),
which stays the reference: the same prompt-guided importance scoring,
budgeted tier selection and bit-packed mixed-precision KV storage, with the
two attention kernels of the main path (flash prefill with the prompt-mass
side channel, fused dequant-attention decode) written in CUDA C++ for
Hopper. Public functions keep the JAX package's tensor layouts and names.
This package imports PyTorch and never JAX.
"""

from .config import (CompressionConfig, ModelConfig, RopeScaling,
                     HIGH, MID, LOW,
                     LLAMA2_7B, LLAMA2_13B, LLAMA3_8B, MISTRAL_7B,
                     MIXTRAL_8X7B, TINYLLAMA_1_1B, reference_anchor_config,
                     tiny_test_model)

__version__ = "0.1.0"

__all__ = [
    "CompressionConfig", "ModelConfig", "RopeScaling",
    "HIGH", "MID", "LOW",
    "LLAMA2_7B", "LLAMA2_13B", "LLAMA3_8B", "MISTRAL_7B",
    "MIXTRAL_8X7B", "TINYLLAMA_1_1B", "reference_anchor_config",
    "tiny_test_model",
]
