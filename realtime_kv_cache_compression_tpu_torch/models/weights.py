"""HF checkpoint loading (safetensors → the port's params tree).

Port of the JAX package's `models/weights.py`. `config_from_hf` reads an
HF `config.json` (Llama / TinyLlama / Mistral, Qwen2's projection biases,
Gemma v1, Mixtral's experts, linear and Llama-3 RoPE scaling);
`load_hf_checkpoint` streams the weights from local safetensors shards,
read by the port's own reader (models/tensor_files.py: no `safetensors`
or `transformers` package is needed), one tensor at a time, each copied
to its device once. The tree has the JAX package's names and layout:
matmul weights [in, out] (HF stores [out, in]), Gemma's (1 + w) folded
into the norm weights in float32, Mixtral's experts stacked [E, H, I] /
[E, I, H]. `hf_tensors` is the inverse: a params tree as HF-named
tensors, for writing a checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, RopeScaling
from .tensor_files import open_checkpoint


def _rope_scaling_from_hf(hf: Dict[str, Any]) -> Optional[RopeScaling]:
    """Parse HF `rope_scaling` (rope_type "linear" or "llama3"/Llama-3.1)."""
    rs = hf.get("rope_scaling")
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind == "linear":
        return RopeScaling(kind="linear", factor=float(rs["factor"]))
    if kind == "llama3":
        return RopeScaling(
            kind="llama3", factor=float(rs["factor"]),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            original_max_position=int(
                rs.get("original_max_position_embeddings", 8192)))
    if kind == "default":
        return None
    raise ValueError(f"unsupported rope_scaling type {kind!r}")


def config_from_hf(checkpoint_dir: str) -> ModelConfig:
    """A ModelConfig from an HF config.json: Llama / TinyLlama / Mistral
    (defaults), Qwen2 (projection biases), Gemma v1 (GeGLU, (1 + w) norms,
    scaled embeddings), Mixtral (num_local_experts), RoPE scaling (linear
    / llama3)."""
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        hf = json.load(f)
    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim", hf["hidden_size"] // num_heads)
    arch = (hf.get("architectures") or [hf.get("model_type", "")])[0]
    is_qwen2 = "Qwen2" in arch or hf.get("model_type") == "qwen2"
    is_gemma = "Gemma" in arch or hf.get("model_type") == "gemma"
    act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
    hidden_act = ("gelu_tanh" if act in ("gelu", "gelu_pytorch_tanh")
                  else "silu")
    return ModelConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=hf.get("tie_word_embeddings", is_gemma),
        qkv_bias=hf.get("attention_bias", False) or is_qwen2,
        hidden_act=hidden_act,
        rms_norm_offset=1.0 if is_gemma else 0.0,
        scale_embeddings=is_gemma,
        rope_scaling=_rope_scaling_from_hf(hf),
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
    )


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


# The params tree's keys and their HF names, shared by both directions.
_ATTENTION = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
              ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"))
_MLP = (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
        ("w_down", "mlp.down_proj"))
# Mixtral: block_sparse_moe.{gate, experts.j.{w1, w3, w2}}: w1 = gate
# [I, H], w3 = up [I, H], w2 = down [H, I], stacked [E, H, I] / [E, I, H]
# after the transpose.
_EXPERTS = (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"))
_BIASES = (("bq", "self_attn.q_proj"), ("bk", "self_attn.k_proj"),
           ("bv", "self_attn.v_proj"))
_NORMS = (("input_norm", "input_layernorm"),
          ("post_norm", "post_attention_layernorm"))


def params_from_tensors(get: Callable[[str], Any], cfg: ModelConfig, target,
                        device="cuda") -> Dict[str, Any]:
    """The params tree from a getter `get(hf_name)` of tensors or numpy
    arrays (HF names, [out, in] matmul weights), in dtype `target` on
    `device`. Shared by safetensors loading and in-memory HF state dicts
    (tests). Every matmul weight is transposed to [in, out] (contiguous);
    Gemma's (1 + w) is folded into the norm weights in float32, then cast.
    """
    target = _torch_dtype(target)

    def fetch(name):
        return torch.as_tensor(get(name)).to(device)

    def w(name):
        return fetch(name).T.to(target).contiguous()

    def vec(name):
        return fetch(name).to(target)

    def norm(name):
        return (fetch(name).float() + cfg.rms_norm_offset).to(target)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layer = {key: w(f"{p}{hf}.weight") for key, hf in _ATTENTION}
        layer.update({key: norm(f"{p}{hf}.weight") for key, hf in _NORMS})
        if cfg.num_experts:
            m = p + "block_sparse_moe."
            layer["moe"] = {
                "gate": w(m + "gate.weight"),
                **{key: torch.stack([w(f"{m}experts.{j}.{hf}.weight")
                                     for j in range(cfg.num_experts)])
                   for key, hf in _EXPERTS}}
        else:
            layer.update({key: w(f"{p}{hf}.weight") for key, hf in _MLP})
        if cfg.qkv_bias:
            layer.update({key: vec(f"{p}{hf}.bias") for key, hf in _BIASES})
        layers.append(layer)
    params = {"embed": vec("model.embed_tokens.weight"), "layers": layers,
              "final_norm": norm("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w("lm_head.weight")
    return params


def hf_tensors(params: Dict[str, Any], cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    """The inverse of `params_from_tensors`: an unquantized params tree as
    HF-named tensors, matmul weights [out, in] (contiguous copies),
    Mixtral's experts one tensor each, Gemma's (1 + w) taken back out of
    the norms in float32. `params_from_tensors` over the result gives the
    tree back bit for bit (for Gemma where |w| < 1: the subtraction and
    the addition are then exact)."""
    def mat(t):
        return t.T.contiguous()

    def norm(t):
        return (t.float() - cfg.rms_norm_offset).to(t.dtype)

    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": norm(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head.weight"] = mat(params["lm_head"])
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        out.update({f"{p}{hf}.weight": mat(layer[key])
                    for key, hf in _ATTENTION})
        out.update({f"{p}{hf}.weight": norm(layer[key])
                    for key, hf in _NORMS})
        if "moe" in layer:
            m = p + "block_sparse_moe."
            out[m + "gate.weight"] = mat(layer["moe"]["gate"])
            for key, hf in _EXPERTS:
                for j, e in enumerate(layer["moe"][key]):
                    out[f"{m}experts.{j}.{hf}.weight"] = mat(e)
        else:
            out.update({f"{p}{hf}.weight": mat(layer[key])
                        for key, hf in _MLP})
        out.update({f"{p}{hf}.bias": layer[key] for key, hf in _BIASES
                    if key in layer})
    return out


def load_hf_checkpoint(checkpoint_dir: str, cfg: Optional[ModelConfig] = None,
                       dtype=None, device="cuda") -> Dict[str, Any]:
    """Load a local HF checkpoint (Llama / Mistral / Qwen2 / Gemma /
    Mixtral) into the params tree on `device`, in `dtype` (default
    cfg.dtype), reading one tensor at a time from its safetensors shards."""
    cfg = cfg or config_from_hf(checkpoint_dir)
    handles = open_checkpoint(checkpoint_dir)
    return params_from_tensors(lambda name: handles[name].get(name), cfg,
                               dtype or cfg.dtype, device=device)


def _flat_leaves(tree, prefix=()):
    """(path, tensor) pairs in the order of JAX's tree flattening: dict
    keys sorted, list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, prefix + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif tree is not None:  # None is an empty subtree, as in JAX
        raise TypeError(f"{'/'.join(prefix)}: save_params_npz takes "
                        f"tensors, not {type(tree).__name__} (quantized "
                        f"trees: models/checkpoint.py)")


def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    """Flat .npz export of a params tree of tensors: one array per
    tensor, named by its path in the tree joined with "/" (the JAX
    package's names, e.g. "layers/0/wq"). numpy has no bfloat16 without
    `ml_dtypes`, so bf16 tensors are stored as their raw 16-bit patterns
    (uint16); other dtypes as themselves."""
    flat = {}
    for keypath, t in _flat_leaves(params):
        t = t.detach().to("cpu")
        flat["/".join(keypath)] = (
            t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())
    np.savez(path, **flat)
