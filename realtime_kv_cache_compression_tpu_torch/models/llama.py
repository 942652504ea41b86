"""Llama-family decoder with real-time prefill KV compression (PyTorch).

Port of the JAX package's `models/llama.py`: parameters are a plain dict
tree with the reference's keys (`init_params`, `params_from_jax`,
`fuse_params`); `prefill_compressed` compresses every layer's K/V into
packed tier pools while it runs, or `prefill_compressed_chunked` runs the
prompt chunk by chunk and compresses once at the end; both take ragged
right-padded batches (`lengths`). `prefill_compressed_prefix_chunked`
compresses each chunk as soon as its attention completes, so later chunks
attend over the compressed pools of earlier ones (uniform batches).
With `importance_source` "query" or "both" the prefills also score each
layer by the observation-window mass of its last queries (the chunked
prefill buffers those query rows in `q_tails`). `decode_loop` decodes over
those pools plus an uncompressed recent ring and, with
`decode_pool_blocks > 0`, a quantized decode pool that full rings flush
into, so a generation may outlive the ring; greedily, or sampled
(`ops/sampling.py`: temperature, top-k, top-p, min-p and penalties, noise
from a `torch.Generator`). The baseline arm is `prefill_uncompressed` +
`decode_loop_uncompressed`.

Kernels: with `use_flash` the prefill attention runs K1
(ops/cuda/flash_prefill.py: mode (a) one-shot, mode (b) per chunk, mode
(d) over the pools plus the diagonal pair on the compressed-prefix path);
with `use_fused` the decode attention runs K2 (ops/cuda/decode_attention.py).
Both default to on for CUDA tensors; on CPU tensors the wrappers take
their plain versions. Quantized weights (models/quantized_params.py)
dispatch in `_matmul`: `Int4Tensor` runs K3 (ops/cuda/int4_matmul.py),
act-quant `QuantizedTensor` K4 (ops/cuda/int8_matmul.py). The reference's
`lax.scan` decode is a Python loop here, and decode updates the recent
rings, the decode pools (and the baseline arm's dense cache) in place, as
chunked prefill does its K/V buffers.

Not ported yet: beam search, speculative decoding, MoE (and its
quantized experts) and the other model families' options beyond the
config fields themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compression.compressor import (compress_layer_kv,
                                      dequantize_layer_cache,
                                      empty_layer_cache, update_cache_chunk)
from ..compression.kv_cache import (CompressedLayerCache, DecodePool,
                                    RecentCache, append_recent,
                                    flush_recent, init_decode_pool,
                                    init_recent_cache, model_dtype)
from ..config import CompressionConfig, ModelConfig
from ..ops.attention import (attention_over_tokens,
                             chunk_attention_with_prompt_mass,
                             positioned_attention_with_prompt_mass,
                             prefill_attention_with_prompt_mass,
                             query_attention_mass, window_attention_mass)
from ..ops.cuda.decode_attention import (decode_attention_plain,
                                         fused_decode_attention)
from ..ops.cuda.flash_prefill import (flash_chunk_attention_with_prompt_mass,
                                      flash_compressed_prefix_attention,
                                      flash_prefill_with_prompt_mass)
from ..ops.cuda.int4_matmul import int4_matmul_tensor
from ..ops.cuda.int8_matmul import dynamic_int8_matmul
from ..ops.sampling import (SamplingParams, init_counts, sample_logits,
                            update_counts)
from .quantized_params import Int4Tensor, QuantizedTensor

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random-init params with the reference's keys, shapes and
    N(0, 1) * fan_in**-0.5 scale, drawn from a torch.Generator seeded with
    `seed` on `device` (other numbers than jax.random's)."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    dtype = model_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, qd, kvd, i = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                     cfg.intermediate_size)

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dtype)

    def ones():
        return torch.ones((h,), dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "wq": dense(h, (h, qd)), "wk": dense(h, (h, kvd)),
            "wv": dense(h, (h, kvd)), "wo": dense(qd, (qd, h)),
            "input_norm": ones(), "post_norm": ones(),
            "w_gate": dense(h, (h, i)), "w_up": dense(h, (h, i)),
            "w_down": dense(i, (i, h)),
        }
        if cfg.qkv_bias:
            layer.update(bq=dense(h, (qd,)), bk=dense(h, (kvd,)),
                         bv=dense(h, (kvd,)))
        layers.append(layer)
    params = {"embed": dense(h, (cfg.vocab_size, h)), "layers": layers,
              "final_norm": ones()}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, (h, cfg.vocab_size))
    return params


def _to_torch(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy kernel
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_jax(tree, device="cuda") -> Params:
    """A JAX params tree (leaves as numpy arrays) → the port's params, with
    the same keys, shapes, dtypes and values. Quantized leaves are known by
    their fields (the JAX package is not imported): `q`, `scale`, `axis`,
    `act_quant` make a `QuantizedTensor`; `q_packed`, `scale`, `in_dim` an
    `Int4Tensor`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if all(hasattr(tree, f) for f in ("q", "scale", "axis", "act_quant")):
        return QuantizedTensor(q=_to_torch(tree.q, device),
                               scale=_to_torch(tree.scale, device),
                               axis=int(tree.axis),
                               act_quant=bool(tree.act_quant))
    if all(hasattr(tree, f) for f in ("q_packed", "scale", "in_dim")):
        return Int4Tensor(q_packed=_to_torch(tree.q_packed, device),
                          scale=_to_torch(tree.scale, device),
                          in_dim=int(tree.in_dim))
    return _to_torch(tree, device)


def _concat_weights(ws):
    """Matmul weights concatenated along the out axis: raw tensors or
    quantized leaves (per-out-channel int8 and grouped int4 keep their
    scales per output column, so this equals the separate matmuls)."""
    w0 = ws[0]
    if isinstance(w0, QuantizedTensor):
        if any(w.axis != 1 for w in ws):
            raise ValueError("only per-out-channel int8 weights fuse")
        return QuantizedTensor(q=torch.cat([w.q for w in ws], dim=1),
                               scale=torch.cat([w.scale for w in ws]),
                               axis=1, act_quant=w0.act_quant)
    if isinstance(w0, Int4Tensor):
        if any(w.in_dim != w0.in_dim or w.group_size != w0.group_size
               for w in ws):
            raise ValueError("int4 weights fuse only with equal in_dim and "
                             "group size")
        return Int4Tensor(
            q_packed=torch.cat([w.q_packed for w in ws], dim=1),
            scale=torch.cat([w.scale for w in ws], dim=1), in_dim=w0.in_dim)
    return torch.cat(ws, dim=1)


def fuse_params(params: Params) -> Params:
    """Fuse each layer's q/k/v projections into one `wqkv` and gate/up into
    one `w_gateup` weight (concatenated along the output axis); raw or
    quantized trees."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        lo = dict(layer)
        if "wq" in lo:
            lo["wqkv"] = _concat_weights([lo.pop("wq"), lo.pop("wk"),
                                          lo.pop("wv")])
            if "bq" in lo:
                lo["bqkv"] = torch.cat([lo.pop("bq"), lo.pop("bk"),
                                        lo.pop("bv")])
        if "w_gate" in lo:
            lo["w_gateup"] = _concat_weights([lo.pop("w_gate"),
                                              lo.pop("w_up")])
        out["layers"].append(lo)
    return out


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _int8_weight_only(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x @ (q * scale) for per-out-channel int8 q [in, out], in the JAX
    package's order: the codes convert (exactly) to x's dtype, the product
    comes out in float32, is scaled, then rounds once to x's dtype. The
    JAX package leaves this to XLA outside any Pallas kernel; here it is a
    plain matmul. On the card a bf16 product reads the bf16 codes and
    writes float32 (`out_dtype`, which the CPU lacks: there both operands
    go to float32, the same products and sums)."""
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype),
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = x.float() @ q.float()
    return (y * scale).to(x.dtype)


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for raw, int8- or int4-quantized weights: act-quant int8 runs
    K4, int4 runs K3 (both take their plain versions on CPU tensors)."""
    if isinstance(w, QuantizedTensor):
        if w.act_quant and w.axis == 1:
            return dynamic_int8_matmul(x, w.q, w.scale)
        return _int8_weight_only(x, w.q, w.scale)
    if isinstance(w, Int4Tensor):
        return int4_matmul_tensor(x, w)
    return x @ w


def _embed_lookup(embed, input_ids: torch.Tensor, dtype,
                  cfg: ModelConfig) -> torch.Tensor:
    ids = input_ids.long()
    if isinstance(embed, QuantizedTensor):  # per-row int8
        out = (embed.q[ids].float() * embed.scale[ids][..., None]).to(dtype)
    else:
        out = embed[ids].to(dtype)
    if cfg.scale_embeddings:
        out = out * torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype)
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast to the model dtype, then scale by w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables at `positions` [B, S] → [B, S, D/2] float32, with the
    reference's "linear" and "llama3" frequency scaling."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=dev) / head_dim))
    if scaling is not None:
        if scaling.kind == "linear":
            inv_freq = inv_freq / scaling.factor
        elif scaling.kind == "llama3":
            wavelen = 2.0 * np.pi / inv_freq
            low_wl = scaling.original_max_position / scaling.low_freq_factor
            high_wl = (scaling.original_max_position
                       / scaling.high_freq_factor)
            smooth = ((scaling.original_max_position / wavelen
                       - scaling.low_freq_factor)
                      / (scaling.high_freq_factor - scaling.low_freq_factor))
            smooth = torch.clamp(smooth, 0.0, 1.0)
            blended = ((1.0 - smooth) * inv_freq / scaling.factor
                       + smooth * inv_freq)
            inv_freq = torch.where(
                wavelen > low_wl, inv_freq / scaling.factor,
                torch.where(wavelen < high_wl, inv_freq, blended))
        else:
            raise ValueError(f"unknown rope scaling kind {scaling.kind!r}")
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE (HF Llama convention). x: [B, S, H, D]."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    if "wqkv" in layer:
        qkv = _matmul(x, layer["wqkv"])
        if "bqkv" in layer:
            qkv = qkv + layer["bqkv"]
        q = qkv[..., :cfg.q_dim]
        k = qkv[..., cfg.q_dim:cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q, k, v = (_matmul(x, layer[n]) for n in ("wq", "wk", "wv"))
        if "bq" in layer:
            q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {name!r}")


def _mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = cfg.hidden_act
    if "w_gateup" in layer:
        gu = _matmul(x, layer["w_gateup"])
        i = gu.shape[-1] // 2
        return _matmul(_act(gu[..., :i], act) * gu[..., i:], layer["w_down"])
    return _matmul(_act(_matmul(x, layer["w_gate"]), act)
                   * _matmul(x, layer["w_up"]), layer["w_down"])


def logits_from_hidden(params: Params, h: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        embed = params["embed"]
        if isinstance(embed, QuantizedTensor):  # per-row scale = per logit
            return _int8_weight_only(h, embed.q.T, embed.scale)
        return h @ embed.T
    return _matmul(h, params["lm_head"])


def _attn_out(layer: Params, h: torch.Tensor, attn: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Residual add of the attention output, then the gated-MLP block."""
    b, s = h.shape[:2]
    h = h + _matmul(attn.reshape(b, s, cfg.q_dim), layer["wo"])
    return h + _mlp(layer, rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
                    cfg)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    """Everything decode needs: per-layer compressed pools + recent rings
    (+ decode pools when ccfg.decode_pool_blocks > 0), and the next
    position per row.

    `ring_fill` holds a host-side count of the tokens in each row's ring
    (the same in every layer), so that `decode_step` knows when a row's
    ring is full and the rings must be flushed into the pools without
    reading a device value. Rings start empty after prefill (an empty
    tuple means every row at 0); a caller that admits rows at other fills
    states them here.
    """

    caches: Tuple[CompressedLayerCache, ...]
    recents: Tuple[RecentCache, ...]
    position: torch.Tensor  # [B] int32
    # One DecodePool per layer when ccfg.decode_pool_blocks > 0, else Nones.
    pools: Tuple[Optional[DecodePool], ...] = ()
    ring_fill: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.ring_fill:
            self.ring_fill = (0,) * self.position.shape[0]


def _prefill_attention(q, k, v, prompt_len, use_flash, prompt_lens=None):
    if use_flash:
        return flash_prefill_with_prompt_mass(q, k, v, prompt_len,
                                              prompt_lens=prompt_lens)
    return prefill_attention_with_prompt_mass(q, k, v, prompt_len,
                                              prompt_lens=prompt_lens)


def _prompt_lens(lengths: torch.Tensor, ccfg: CompressionConfig,
                 prompt_len: int) -> torch.Tensor:
    """Per-row prompt lengths, the reference heuristic max(1, min(len *
    prompt_frac, prompt_len)) on the true lengths."""
    return torch.clamp((lengths.float() * ccfg.prompt_frac).to(torch.int32),
                       1, prompt_len)


def _prefill_start(params, input_ids, cfg):
    b, s = input_ids.shape
    h = _embed_lookup(params["embed"], input_ids, model_dtype(cfg), cfg)
    positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    return h, positions, cos, sin


def _last_hidden(h: torch.Tensor, lengths) -> torch.Tensor:
    """Hidden state at each row's last true position: [B, hidden]."""
    if lengths is None:
        return h[:, -1]
    bidx = torch.arange(h.shape[0], device=h.device)
    return h[bidx, lengths.to(h.device).long() - 1]


def _end_positions(b: int, s: int, lengths, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((b,), s, dtype=torch.int32, device=device)
    return lengths.to(device=device, dtype=torch.int32)


def _decode_buffers(b: int, max_decode_len: int, cfg: ModelConfig,
                    ccfg: CompressionConfig, device):
    """A layer's empty recent ring and decode pool (None without one)."""
    return (init_recent_cache(b, max_decode_len, cfg, device=device),
            init_decode_pool(b, max_decode_len, ccfg, cfg, device=device))


def prefill_compressed(
    params: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int = 128,
    use_flash: Optional[bool] = None,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, DecodeState, List[Dict[str, torch.Tensor]]]:
    """Full-sequence prefill with per-layer real-time KV compression.

    input_ids: [B, S]. lengths: optional [B] true lengths of right-padded
    ragged rows: padding is never stored, per-row prompt lengths follow the
    true lengths, and the logits and decode positions are each row's last
    true position. use_flash=None runs K1 on CUDA inputs. With
    ccfg.importance_source "query" or "both", each layer's RoPE'd q and k
    (those K1 took) also give the observation-window mass of the last
    `ccfg.query_window_for(S)` queries, ending at each row's true length on
    ragged rows. Returns (logits for the last position [B, V], decode
    state, per-layer stats).
    """
    if use_flash is None:
        use_flash = input_ids.is_cuda
    b, s = input_ids.shape
    prompt_len = ccfg.prompt_length(s)
    h, positions, cos, sin = _prefill_start(params, input_ids, cfg)
    token_valid = prompt_lens = None
    if lengths is not None:
        lengths = lengths.to(h.device)
        token_valid = positions < lengths[:, None]
        prompt_lens = _prompt_lens(lengths, ccfg, prompt_len)
    need_qmass = ccfg.importance_source != "prompt"
    q_lengths = (token_valid.sum(dim=-1)
                 if need_qmass and token_valid is not None else None)
    caches, recents, pools, all_stats = [], [], [], []
    for layer_idx, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn, prompt_mass = _prefill_attention(q, k, v, prompt_len,
                                               use_flash, prompt_lens)
        qmass = (query_attention_mass(q, k, ccfg.query_window_for(s),
                                      lengths=q_lengths,
                                      pool=ccfg.query_mass_pool)
                 if need_qmass else None)
        cache, stats = compress_layer_kv(k, v, prompt_mass, layer_idx, ccfg,
                                         cfg, token_valid=token_valid,
                                         prompt_lens=prompt_lens,
                                         query_mass=qmass)
        caches.append(cache)
        all_stats.append(stats)
        recent, pool = _decode_buffers(b, max_decode_len, cfg, ccfg,
                                       h.device)
        recents.append(recent)
        pools.append(pool)
        if ccfg.recompute_prefill_attention:
            # Reference-parity mode: recompute the prefill output against
            # the compressed K/V at the survivors' exact positions.
            k_d, v_d, pos_c, valid = dequantize_layer_cache(cache, ccfg)
            attn = attention_over_tokens(q, k_d.to(q.dtype), v_d.to(q.dtype),
                                         pos_c, valid, positions)
        h = _attn_out(layer, h, attn, cfg)
    logits = logits_from_hidden(params, _last_hidden(h, lengths), cfg)
    state = DecodeState(caches=tuple(caches), recents=tuple(recents),
                        position=_end_positions(b, s, lengths, h.device),
                        pools=tuple(pools))
    return logits, state, all_stats


def prefill_uncompressed(
    params: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    lengths: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Vanilla prefill (baseline arm). Returns (last-position logits,
    (K, V)) with K/V stacked over layers: [L, B, S, H_kv, D]. With
    `lengths`, right-padded ragged rows take their logits at their true
    last position (causality isolates them from the padding keys, and
    decode overwrites the pad slots)."""
    if use_flash is None:
        use_flash = input_ids.is_cuda
    h, _, cos, sin = _prefill_start(params, input_ids, cfg)
    ks, vs = [], []
    for layer in params["layers"]:
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn, _ = _prefill_attention(q, k, v, 1, use_flash)
        ks.append(k)
        vs.append(v)
        h = _attn_out(layer, h, attn, cfg)
    logits = logits_from_hidden(params, _last_hidden(h, lengths), cfg)
    return logits, (torch.stack(ks), torch.stack(vs))


# ---------------------------------------------------------------------------
# Chunked prefill (serving: interleaves prompt processing with decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkedPrefillState:
    """Carry between prefill chunks: per-layer K/V buffers filled up to
    `offset`, the per-layer prompt-mass side channel, and the hidden state
    at each row's final position (captured by the chunk that holds it).
    With query-guided importance (ccfg.importance_source != "prompt"),
    `q_tails` buffers each layer's observation-window query rows (the last
    W true positions of each row), so that the finish computes the query
    mass over the complete K buffers. `offset` is a host int: the chunk
    loop runs on the host."""

    k_bufs: Tuple[torch.Tensor, ...]   # per layer [B, S, H_kv, D]
    v_bufs: Tuple[torch.Tensor, ...]
    masses: Tuple[torch.Tensor, ...]   # per layer [B, S] float32
    last_h: torch.Tensor               # [B, hidden]
    offset: int = 0
    q_tails: Tuple[torch.Tensor, ...] = ()  # per layer [B, W, H_q, D]


def prefill_chunked_init(batch: int, seq_len: int, cfg: ModelConfig,
                         ccfg: Optional[CompressionConfig] = None,
                         device="cuda") -> ChunkedPrefillState:
    """Zero-initialised chunked-prefill carry for a [batch, seq_len]
    bucket, on `device`. `ccfg` matters only when it selects query-guided
    importance: the carry then holds the per-layer window query buffers
    (`q_tails`, W = ccfg.query_window_for(seq_len))."""
    dtype = model_dtype(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    q_tails = ()
    if ccfg is not None and ccfg.importance_source != "prompt":
        tail = (batch, ccfg.query_window_for(seq_len), cfg.num_heads,
                cfg.head_dim)
        q_tails = tuple(zeros(tail) for _ in range(cfg.num_layers))
    return ChunkedPrefillState(
        k_bufs=tuple(zeros(kv) for _ in range(cfg.num_layers)),
        v_bufs=tuple(zeros(kv) for _ in range(cfg.num_layers)),
        masses=tuple(zeros((batch, seq_len), torch.float32)
                     for _ in range(cfg.num_layers)),
        last_h=zeros((batch, cfg.hidden_size)), q_tails=q_tails)


def _tail_positions(b: int, w: int, s: int, lengths, device) -> torch.Tensor:
    """[B, W] global positions of the observation-window slots: slot t of
    row r holds the query at len_r - W + t (negative: no such query)."""
    lens = (lengths.to(device=device, dtype=torch.int32) if lengths is not None
            else torch.full((b,), s, dtype=torch.int32, device=device))
    return lens[:, None] - w + torch.arange(w, device=device)[None]


def prefill_chunked_step(
    params: Params,
    chunk_ids: torch.Tensor,
    st: ChunkedPrefillState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    lengths: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
) -> ChunkedPrefillState:
    """Advance the prefill by one chunk of tokens, chunk_ids [B, c].

    Writes the chunk's K/V and prompt mass into the state's buffers in
    place, attends the chunk over the position-ordered buffers (K1 mode (b)
    with use_flash, which defaults to on for CUDA inputs), captures the
    hidden state of rows whose last true position lies in this chunk, and
    with `q_tails` the window query rows whose positions lie in it (from
    the host offset and the device lengths: no device value is read).
    Per-row softmax over the buffer equals full-sequence causal attention,
    so caches and logits match the one-shot `prefill_compressed`. Returns
    the state with `offset` advanced by c.
    """
    if use_flash is None:
        use_flash = chunk_ids.is_cuda
    attend = (flash_chunk_attention_with_prompt_mass if use_flash
              else chunk_attention_with_prompt_mass)
    b, c = chunk_ids.shape
    off = st.offset
    s_total = st.k_bufs[0].shape[1]
    prompt_len = ccfg.prompt_length(s_total)
    prompt_lens = None
    if lengths is not None:
        lengths = lengths.to(chunk_ids.device)
        prompt_lens = _prompt_lens(lengths, ccfg, prompt_len)

    h = _embed_lookup(params["embed"], chunk_ids, model_dtype(cfg), cfg)
    positions = (off + torch.arange(c, device=chunk_ids.device))[None]
    cos, sin = rope_tables(positions.expand(b, c), cfg.head_dim,
                           cfg.rope_theta, cfg.rope_scaling)
    if st.q_tails:
        w_win = st.q_tails[0].shape[1]
        tail_pos = _tail_positions(b, w_win, s_total, lengths, h.device)
        t_in_chunk = ((tail_pos >= off) & (tail_pos < off + c))[
            :, :, None, None]
        t_idx = torch.clamp(tail_pos - off, 0, c - 1).long()[
            :, :, None, None].expand(b, w_win, cfg.num_heads, cfg.head_dim)
    for li, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_buf, v_buf = st.k_bufs[li], st.v_bufs[li]
        k_buf[:, off:off + c] = k
        v_buf[:, off:off + c] = v
        attn, mass_c = attend(q, k_buf, v_buf, off, prompt_len,
                              prompt_lens=prompt_lens)
        st.masses[li][:, off:off + c] = mass_c
        if st.q_tails:
            q_tail = st.q_tails[li]
            q_tail.copy_(torch.where(t_in_chunk, torch.gather(q, 1, t_idx),
                                     q_tail))
        h = _attn_out(layer, h, attn, cfg)

    # Capture the hidden state at each row's final position if it falls in
    # this chunk (rows keep their earlier capture otherwise).
    last_pos = (lengths.long() - 1 if lengths is not None
                else torch.full((b,), s_total - 1, device=h.device))
    in_chunk = (last_pos >= off) & (last_pos < off + c)
    idx = torch.clamp(last_pos - off, 0, c - 1)
    cand = h[torch.arange(b, device=h.device), idx]
    last_h = torch.where(in_chunk[:, None], cand, st.last_h)
    return dataclasses.replace(st, last_h=last_h, offset=off + c)


def prefill_chunked_finish(
    params: Params,
    st: ChunkedPrefillState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int = 128,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, DecodeState, List[Dict[str, torch.Tensor]]]:
    """Compress the filled buffers into the decode state + last logits.

    Compression runs once over the complete K/V and prompt mass, as the
    one-shot prefill's per-layer `compress_layer_kv` does: chunking changes
    when the attention runs, not what is compressed. With `q_tails` the
    query mass of the buffered window rows is computed here, over the
    complete K buffers."""
    b, s = st.masses[0].shape
    dev = st.last_h.device
    token_valid = prompt_lens = None
    if lengths is not None:
        lengths = lengths.to(dev)
        token_valid = torch.arange(s, device=dev)[None] < lengths[:, None]
        prompt_lens = _prompt_lens(lengths, ccfg, ccfg.prompt_length(s))
    if st.q_tails:
        tail_pos = _tail_positions(b, st.q_tails[0].shape[1], s, lengths, dev)
        key_ok = (token_valid if token_valid is not None
                  else torch.ones((b, s), dtype=torch.bool, device=dev))
    caches, recents, pools, all_stats = [], [], [], []
    for li in range(cfg.num_layers):
        qmass = None
        if st.q_tails:
            qmass = window_attention_mass(
                st.q_tails[li], torch.clamp(tail_pos, min=0), tail_pos >= 0,
                st.k_bufs[li], key_ok, pool=ccfg.query_mass_pool)
        cache, stats = compress_layer_kv(
            st.k_bufs[li], st.v_bufs[li], st.masses[li], li, ccfg, cfg,
            token_valid=token_valid, prompt_lens=prompt_lens,
            query_mass=qmass)
        caches.append(cache)
        all_stats.append(stats)
        recent, pool = _decode_buffers(b, max_decode_len, cfg, ccfg, dev)
        recents.append(recent)
        pools.append(pool)
    logits = logits_from_hidden(params, st.last_h, cfg)
    state = DecodeState(caches=tuple(caches), recents=tuple(recents),
                        position=_end_positions(b, s, lengths, dev),
                        pools=tuple(pools))
    return logits, state, all_stats


def prefill_compressed_chunked(
    params: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    chunk_size: int,
    max_decode_len: int = 128,
    lengths: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
) -> Tuple[torch.Tensor, DecodeState, List[Dict[str, torch.Tensor]]]:
    """init → one `prefill_chunked_step` per chunk → finish: the chunked
    equivalent of `prefill_compressed` (the same caches and logits to
    float tolerance). input_ids: [B, S] with S a multiple of chunk_size.
    The serving engine calls the three phases itself to interleave chunks
    with decode."""
    st = _prefill_chunks(params, input_ids, cfg, ccfg, chunk_size, lengths,
                         use_flash)
    return prefill_chunked_finish(params, st, cfg, ccfg,
                                  max_decode_len=max_decode_len,
                                  lengths=lengths)


def _prefill_chunks(params, input_ids, cfg, ccfg, chunk_size, lengths,
                    use_flash) -> ChunkedPrefillState:
    """init → one `prefill_chunked_step` per chunk: the filled carry that
    `prefill_chunked_finish` compresses (its masses are the per-layer
    prompt masses the compression scores)."""
    b, s = input_ids.shape
    if s % chunk_size:
        raise ValueError(f"seq len {s} not a multiple of chunk {chunk_size}")
    st = prefill_chunked_init(b, s, cfg, ccfg, device=input_ids.device)
    for off in range(0, s, chunk_size):
        st = prefill_chunked_step(params, input_ids[:, off:off + chunk_size],
                                  st, cfg, ccfg, lengths=lengths,
                                  use_flash=use_flash)
    return st


# ---------------------------------------------------------------------------
# Compressed-prefix chunked prefill: later chunks attend over the compressed
# pools of earlier chunks instead of the full uncompressed KV buffer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressedChunkedState:
    """Carry for compressed-prefix chunked prefill.

    There are no full-length K/V or mass buffers: each chunk is compressed
    into its slot range of the preallocated tier pools (`empty_layer_cache`)
    as soon as its attention completes, so the per-layer carry is the
    compressed cache, and chunk t attends over about kept * t * c surviving
    prefix tokens instead of t * c. Against the full-buffer path this
    approximates: later chunks see the quantized, selected prefix; each
    chunk's importance normalises over its own mass range; and a chunk's
    mass comes only from queries up to that chunk. Prompt-source
    importance only. `offset` is a host int: the chunk loop runs on the
    host.
    """

    caches: Tuple[CompressedLayerCache, ...]
    last_h: torch.Tensor        # [B, hidden]
    offset: int = 0


def prefill_chunked_compressed_init(
        batch: int, seq_len: int, chunk_size: int, cfg: ModelConfig,
        ccfg: CompressionConfig, device="cuda") -> CompressedChunkedState:
    """All-invalid compressed caches for seq_len / chunk_size chunks of a
    [batch, seq_len] prompt, on `device`. Raises ValueError when chunk_size
    does not divide seq_len, or for query-guided importance (its
    observation window lies at the end of the sequence, after the chunks
    it would score are compressed)."""
    if seq_len % chunk_size:
        raise ValueError(f"seq len {seq_len} not a multiple of chunk "
                         f"{chunk_size}")
    if ccfg.importance_source != "prompt":
        raise ValueError(
            "compressed-prefix chunked prefill supports importance_source="
            "'prompt' only (the observation window lives at the END of the "
            "sequence — it cannot score chunks that are compressed before "
            "it exists; use prefill_chunked_* for query-guided scoring)")
    n_chunks = seq_len // chunk_size
    return CompressedChunkedState(
        caches=tuple(empty_layer_cache(batch, chunk_size, n_chunks, li, ccfg,
                                       cfg, device=device)
                     for li in range(cfg.num_layers)),
        last_h=torch.zeros((batch, cfg.hidden_size), dtype=model_dtype(cfg),
                           device=device))


def prefill_chunked_compressed_step(
    params: Params,
    chunk_ids: torch.Tensor,
    st: CompressedChunkedState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    total_len: int,
    use_flash: Optional[bool] = None,
) -> CompressedChunkedState:
    """Advance compressed-prefix prefill by one chunk, chunk_ids [B, c]
    (uniform batches).

    Per layer: attention of the chunk's queries over {compressed pools so
    far} ++ {own chunk K/V} with explicit positions (use_flash, on by
    default for CUDA inputs: K1 mode (d) over the pools, the diagonal pair
    over the chunk, merged; else the dense
    `positioned_attention_with_prompt_mass`); then the chunk is compressed
    with its own prompt mass (chunk-local min-max, global positions) and
    written into its slot range of the state's caches in place. Returns the
    state with `offset` advanced by c.
    """
    if use_flash is None:
        use_flash = chunk_ids.is_cuda
    b, c = chunk_ids.shape
    off = st.offset
    prompt_len = ccfg.prompt_length(total_len)
    h = _embed_lookup(params["embed"], chunk_ids, model_dtype(cfg), cfg)
    positions = (off + torch.arange(c, device=chunk_ids.device))[None] \
        .expand(b, c)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    for li, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        cache = st.caches[li]
        k_p, v_p, pos_p, valid_p = dequantize_layer_cache(cache, ccfg,
                                                          q.dtype)
        if use_flash:
            attn, mass_c = flash_compressed_prefix_attention(
                q, k_p, v_p, pos_p, valid_p, k, v, off, prompt_len)
        else:
            attn, mass_c = positioned_attention_with_prompt_mass(
                q, torch.cat([k_p, k], dim=1), torch.cat([v_p, v], dim=1),
                torch.cat([pos_p, positions.to(torch.int32)], dim=1),
                torch.cat([valid_p, torch.ones((b, c), dtype=torch.bool,
                                               device=q.device)], dim=1),
                positions, prompt_len)
        mn = mass_c.amin(dim=-1, keepdim=True)
        mx = mass_c.amax(dim=-1, keepdim=True)
        # A chunk whose mass is (near-)constant, e.g. one inside the prompt
        # region where every row's mass is 1, must score as constant:
        # min-max normalising a float-noise-wide range would blow backend
        # noise up to full score scale. The wide span makes the mass term
        # about 0, so the position and floor terms decide.
        mx = torch.where(mx - mn < 1e-3, mn + 1e6, mx)
        chunk_cache, _ = compress_layer_kv(
            k, v, mass_c, li, ccfg, cfg, shard_offset=off,
            total_len=total_len, minmax=(mn, mx))
        update_cache_chunk(cache, chunk_cache, off // c)
        h = _attn_out(layer, h, attn, cfg)
    last_h = st.last_h
    if off <= total_len - 1 < off + c:
        last_h = h[:, total_len - 1 - off]
    return dataclasses.replace(st, last_h=last_h, offset=off + c)


def prefill_chunked_compressed_finish(
    params: Params,
    st: CompressedChunkedState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_decode_len: int = 128,
) -> Tuple[torch.Tensor, DecodeState, List[Dict[str, torch.Tensor]]]:
    """Last-position logits + the decode state over the caches the chunks
    built (they are the decode caches: no second compression pass). Stats
    are the reference's four keys per layer, counted from the tiers'
    `valid`: seq_len, kept_tokens, compression_ratio and
    token_memory_savings (so `summarize_layer_stats`, which wants the full
    set, raises KeyError on them, as the reference's does)."""
    b = st.last_h.shape[0]
    dev = st.last_h.device
    total = float(max(st.offset, 1))
    all_stats = []
    for cache in st.caches:
        kept = sum(t.valid.sum(dim=-1) for t in cache.tiers)
        all_stats.append({
            "seq_len": torch.full((b,), st.offset, dtype=torch.int32,
                                  device=dev),
            "kept_tokens": kept,
            "compression_ratio": kept / total,
            "token_memory_savings": 1.0 - kept / total,
        })
    logits = logits_from_hidden(params, st.last_h, cfg)
    buffers = [_decode_buffers(b, max_decode_len, cfg, ccfg, dev)
               for _ in st.caches]
    state = DecodeState(
        caches=st.caches, recents=tuple(r for r, _ in buffers),
        position=torch.full((b,), st.offset, dtype=torch.int32, device=dev),
        pools=tuple(p for _, p in buffers))
    return logits, state, all_stats


def prefill_compressed_prefix_chunked(
    params: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    chunk_size: int,
    max_decode_len: int = 128,
    use_flash: Optional[bool] = None,
) -> Tuple[torch.Tensor, DecodeState, List[Dict[str, torch.Tensor]]]:
    """init → one `prefill_chunked_compressed_step` per chunk → finish,
    for a uniform batch input_ids [B, S] with S a multiple of chunk_size.
    Returns (last-position logits [B, V], decode state, per-layer stats)."""
    b, s = input_ids.shape
    st = prefill_chunked_compressed_init(b, s, chunk_size, cfg, ccfg,
                                         device=input_ids.device)
    for off in range(0, s, chunk_size):
        st = prefill_chunked_compressed_step(
            params, input_ids[:, off:off + chunk_size], st, cfg, ccfg,
            total_len=s, use_flash=use_flash)
    return prefill_chunked_compressed_finish(params, st, cfg, ccfg,
                                             max_decode_len=max_decode_len)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def ring_fill_step(ring_fill: Tuple[int, ...], capacity: int,
                   pooled: bool) -> Tuple[bool, Tuple[int, ...]]:
    """One decode step's host-side ring bookkeeping: whether the rings must
    be flushed before the append (some row's ring is full and there are
    pools), and each row's fill after it. A flush empties the full rows
    only (`flush_recent` masks per row); every row then appends one token,
    which a full ring without a pool drops."""
    full = [n >= capacity for n in ring_fill]
    flush = pooled and any(full)
    return flush, tuple(min((0 if flush and f else n) + 1, capacity)
                        for f, n in zip(full, ring_fill))


def decode_step(
    params: Params,
    token: torch.Tensor,
    state: DecodeState,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    use_fused: Optional[bool] = None,
) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step over the compressed caches. token: [B] ids.
    use_fused=None runs K2 on CUDA inputs. With decode pools, full rings
    are first flushed into the pools (`flush_recent`, which flushes the
    full rows only; the state's host-side per-row `ring_fill` says when any
    row is full), so no ring overflows. The state's rings and pools are
    updated in place; returns (logits [B, V], the state with position + 1).
    """
    if use_fused is None:
        use_fused = token.is_cuda
    h = _embed_lookup(params["embed"], token, model_dtype(cfg), cfg)[:, None]
    q_pos = state.position[:, None]
    cos, sin = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    pools = state.pools or (None,) * len(state.caches)
    capacity = state.recents[0].capacity if state.recents else 0
    flush, ring_fill = ring_fill_step(state.ring_fill, capacity,
                                      pools[0] is not None)
    for layer, cache, recent, pool in zip(params["layers"], state.caches,
                                          state.recents, pools):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if flush:
            flush_recent(recent, pool, ccfg, cfg)
        append_recent(recent, k, v, q_pos)
        if use_fused:
            attn = fused_decode_attention(q, cache, recent, q_pos, ccfg,
                                          pool=pool)
        else:
            attn = decode_attention_plain(q, cache, recent, q_pos, ccfg,
                                          dtype=q.dtype, pool=pool)
        h = _attn_out(layer, h, attn, cfg)
    logits = logits_from_hidden(params, h[:, 0], cfg)
    state = dataclasses.replace(state, position=state.position + 1,
                                ring_fill=ring_fill)
    return logits, state


def decode_loop(
    params: Params,
    first_token: torch.Tensor,
    state: DecodeState,
    n_steps: int,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    use_fused: Optional[bool] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    sampling: Optional[SamplingParams] = None,
    counts: Optional[torch.Tensor] = None,
    return_counts: bool = False,
    return_logprobs: bool = False,
):
    """n_steps of decode. With decode pools (ccfg.decode_pool_blocks > 0)
    any n_steps is supported: full rings flush into the quantized pool, and
    past ring * (blocks + 1) decode tokens the oldest pool block is
    overwritten (the prefill tiers are never evicted). Without pools the
    recent rings must hold n_steps tokens (appends past a full ring are
    dropped).

    temperature 0 is greedy; above 0 samples, with noise from `generator`
    (a torch.Generator on the tokens' device; required, else ValueError).
    `sampling` (ops/sampling.SamplingParams) supersedes `temperature` and
    adds top-k / top-p / min-p filters and repetition / presence /
    frequency penalties. Penalties read per-row occurrence counts carried
    across steps: `counts` ([B, vocab] int32, every token generated so far
    included) continues an earlier generation; without it the count starts
    from `first_token`. Returns (tokens [B, n_steps], state), then the
    final counts with `return_counts`, then with `return_logprobs` the
    log-softmax of the raw logits at each emitted token [B, n_steps]
    (float32; whatever the temperature, filters and penalties)."""
    if sampling is None:
        sampling = SamplingParams(temperature=temperature)
    if not sampling.is_greedy and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    track_counts = sampling.uses_penalties or return_counts
    if track_counts and counts is None:
        counts = init_counts(first_token.shape[0], cfg.vocab_size,
                             first_token)
    tok, toks, lps = first_token, [], []
    for _ in range(n_steps):
        logits, state = decode_step(params, tok, state, cfg, ccfg,
                                    use_fused=use_fused)
        tok = sample_logits(logits, generator, sampling,
                            counts=counts if track_counts else None)
        if track_counts:
            counts = update_counts(counts, tok)
        if return_logprobs:
            lp = torch.log_softmax(logits.float(), dim=-1)
            lps.append(torch.gather(lp, 1, tok[:, None])[:, 0])
        toks.append(tok)
    b = first_token.shape[0]
    result = [torch.stack(toks, dim=1) if toks
              else first_token.new_zeros((b, 0)), state]
    if return_counts:
        result.append(counts)
    if return_logprobs:
        result.append(torch.stack(lps, dim=1) if lps else torch.zeros(
            (b, 0), dtype=torch.float32, device=first_token.device))
    return tuple(result)


def decode_step_uncompressed(
    params: Params,
    token: torch.Tensor,
    kv: Tuple[torch.Tensor, torch.Tensor],
    position: torch.Tensor,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Baseline decode over a padded dense KV cache (K, V) [L, B, M, H, D];
    slots < `position` are live. Writes this step's K/V into the cache in
    place."""
    ks, vs = kv
    b, m = ks.shape[1], ks.shape[2]
    h = _embed_lookup(params["embed"], token, model_dtype(cfg), cfg)[:, None]
    q_pos = position[:, None]
    cos, sin = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    pos_all = torch.arange(m, device=token.device)[None].expand(b, m)
    valid = pos_all <= q_pos
    bidx = torch.arange(b, device=token.device)
    pos_l = position.long()
    for layer_idx, layer in enumerate(params["layers"]):
        x = rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, x, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ks[layer_idx][bidx, pos_l] = k[:, 0]
        vs[layer_idx][bidx, pos_l] = v[:, 0]
        attn = attention_over_tokens(q, ks[layer_idx], vs[layer_idx],
                                     pos_all, valid, q_pos)
        h = _attn_out(layer, h, attn, cfg)
    logits = logits_from_hidden(params, h[:, 0], cfg)
    return logits, kv, position + 1


def decode_loop_uncompressed(
    params: Params,
    first_token: torch.Tensor,
    kv: Tuple[torch.Tensor, torch.Tensor],
    position: torch.Tensor,
    n_steps: int,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Baseline-arm greedy decode over the padded dense cache."""
    tok, toks = first_token, []
    for _ in range(n_steps):
        logits, kv, position = decode_step_uncompressed(params, tok, kv,
                                                        position, cfg)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), kv, position


def generate(
    params: Params,
    input_ids: torch.Tensor,
    cfg: ModelConfig,
    ccfg: CompressionConfig,
    max_new_tokens: int = 32,
    use_flash: Optional[bool] = None,
    use_fused_decode: Optional[bool] = None,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    sampling: Optional[SamplingParams] = None,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Generation with compressed KV: greedy, or sampled when temperature
    > 0 (`sampling` adds the filters and penalties of `decode_loop`; a
    sampled run without a `generator` draws from one seeded with 0 on the
    prompt's device). Returns (generated ids [B, max_new_tokens], per-layer
    prefill compression stats); tokens after a row's first EOS are set to
    EOS."""
    if sampling is None:
        sampling = SamplingParams(temperature=temperature)
    if not sampling.is_greedy and generator is None:
        generator = torch.Generator(device=input_ids.device).manual_seed(0)
    logits, state, stats = prefill_compressed(
        params, input_ids, cfg, ccfg, max_decode_len=max_new_tokens,
        use_flash=use_flash)
    tok = sample_logits(logits, generator, sampling)
    rest, _ = decode_loop(params, tok, state, max_new_tokens - 1, cfg, ccfg,
                          use_fused=use_fused_decode, generator=generator,
                          sampling=sampling)
    out = torch.cat([tok[:, None], rest], dim=1)
    if eos_token_id is not None:
        is_eos = (out == eos_token_id).to(torch.int32)
        hit = torch.cumsum(is_eos, dim=1) - is_eos
        out = torch.where(hit > 0, torch.full_like(out, eos_token_id), out)
    return out, stats
