"""The port's model families vs HuggingFace `transformers` (CPU, float32).

Random-init tiny HF models (no downloads), as in
tests/test_model_families.py and tests/test_moe.py's Mixtral case: Llama,
Mistral, Llama with Llama-3 and with linear RoPE scaling, Qwen2 (q/k/v
biases made decidedly non-zero), Gemma (GeGLU, (1 + w) norms with w != 0,
scaled embeddings, tied head) and Mixtral (4 experts, top 2). Their state
dicts go through the port's `params_from_tensors`, and the port's
`forward_logits` (plain attention on CPU tensors; Mixtral's MLP through
`ops/moe.py`, ragged at this token count) is held to HF's logits at every
position.

Tolerance 1e-5 absolute: both sides are PyTorch in float32 and differ
only in the order of their sums (the JAX package's test allows 2e-3
across frameworks). Measured here: at most 1.8e-7 over the seven cases.
"""

import numpy as np
import pytest
import torch
import transformers

import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models.weights import (
    params_from_tensors)

ATOL = 1e-5
DIMS = dict(hidden_size=64, intermediate_size=112, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=128,
            max_position_embeddings=256)
HF_DIMS = dict(hidden_size=64, intermediate_size=112, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=128, max_position_embeddings=256)
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 64}

# family: (HF config class, HF model class, HF extras, port config extras)
CASES = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
              dict(rms_norm_eps=1e-5), dict(rms_norm_eps=1e-5)),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM,
                dict(rms_norm_eps=1e-5, sliding_window=None),
                dict(rms_norm_eps=1e-5)),
    "llama3_scaling": (
        transformers.LlamaConfig, transformers.LlamaForCausalLM,
        dict(rope_scaling=LLAMA3, rope_theta=500000.0, rms_norm_eps=1e-5),
        dict(rope_theta=500000.0, rope_scaling=rt.RopeScaling(
            kind="llama3", factor=8.0, low_freq_factor=1.0,
            high_freq_factor=4.0, original_max_position=64))),
    "linear_scaling": (
        transformers.LlamaConfig, transformers.LlamaForCausalLM,
        dict(rope_scaling={"rope_type": "linear", "factor": 2.0},
             rms_norm_eps=1e-5),
        dict(rope_scaling=rt.RopeScaling(kind="linear", factor=2.0))),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM,
              dict(rms_norm_eps=1e-6, rope_theta=1e6,
                   tie_word_embeddings=False),
              dict(rms_norm_eps=1e-6, rope_theta=1e6, qkv_bias=True)),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM,
              dict(rms_norm_eps=1e-6, tie_word_embeddings=True,
                   hidden_activation="gelu_pytorch_tanh"),
              dict(rms_norm_eps=1e-6, tie_word_embeddings=True,
                   hidden_act="gelu_tanh", rms_norm_offset=1.0,
                   scale_embeddings=True)),
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                dict(rms_norm_eps=1e-5, rope_theta=1e6, num_local_experts=4,
                     num_experts_per_tok=2, tie_word_embeddings=False),
                dict(rope_theta=1e6, num_experts=4, num_experts_per_tok=2)),
}


@pytest.mark.parametrize("family", list(CASES))
def test_forward_logits_match_hf(family):
    hf_cfg_cls, model_cls, hf_extra, extra = CASES[family]
    seed = list(CASES).index(family)
    torch.manual_seed(seed)
    model = model_cls(hf_cfg_cls(**HF_DIMS, **hf_extra)).eval()
    with torch.no_grad():  # non-zero biases and Gemma's w in (1 + w)
        for name, p in model.named_parameters():
            if name.endswith(".bias") or (family == "gemma"
                                          and "norm" in name):
                p.add_(torch.randn_like(p) * (1.0 if "bias" in name else 0.1))
    cfg = rt.ModelConfig(**DIMS, dtype="float32", **extra)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    params = params_from_tensors(sd.__getitem__, cfg, torch.float32,
                                 device="cpu")
    if cfg.qkv_bias:
        assert float(params["layers"][0]["bq"].abs().max()) > 0.1
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits
        got = tl.forward_logits(params, torch.tensor(ids), cfg)
    err = float((got - want).abs().max())
    assert err < ATOL, f"{family}: max |dlogits| = {err}"
