"""Configuration for the PyTorch port of the KV-cache compression framework.

The same frozen, hashable dataclasses as the JAX package's `config.py`
(field for field, default for default, with the same validation and derived
methods), so a configuration means the same thing in both packages. Pure
Python: importing it pulls in neither JAX nor PyTorch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

VALID_BITS = (2, 4, 8, 16)

# Precision tier labels, matching the reference encoding
# (dynamic_quantization.py:32): 0 = LOW, 1 = MID, 2 = HIGH.
LOW, MID, HIGH = 0, 1, 2
TIER_NAMES = ("low", "mid", "high")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static compression hyperparameters.

    Mirrors the surface of the reference config (base_config.py:16-35) with
    explicit, validated bit tiers (the reference was internally inconsistent:
    16/8/4 in config vs 8/4/2 in README/tests — we default to 8/4/2, the
    variant the reference's own unit tests pin, and support both).
    """

    # Three-term importance weights: s_i = alpha·Â_P,i·w_l + beta·b_pos(i) + gamma·r(i)
    alpha: float = 0.4
    beta: float = 0.3
    gamma: float = 0.3

    # Precision thresholds (threshold tier mode)
    theta_h: float = 0.7
    theta_m: float = 0.3

    # Layer-group propagation ratios (reference base_config.py:28-30)
    early_layer_ratio: float = 0.8
    middle_layer_ratio: float = 0.6
    later_layer_ratio: float = 0.4
    # Layer-group boundaries as depth fractions (selective_propagation.py:18-21)
    early_boundary_frac: float = 0.3
    middle_boundary_frac: float = 0.7

    # Bit widths per tier. 16 means "store raw bf16, no quantization".
    high_precision_bits: int = 8
    medium_precision_bits: int = 4
    low_precision_bits: int = 2

    # Per-layer weights w_l; auto-generated 1.0 → 0.5 linearly if None
    # (reference base_config.py:45-51). Tuple so the config stays hashable.
    layer_weights: Optional[Tuple[float, ...]] = None
    num_layers: int = 32

    # Prompt identification heuristic: first max(1, min(S * prompt_frac, prompt_cap))
    # positions (reference unified_compressor.py:55).
    prompt_frac: float = 0.2
    prompt_cap: int = 128

    # --- knobs beyond the reference (no reference counterpart) ---

    # Tier assignment mode:
    #   "threshold": reference semantics — tier from theta_h/theta_m comparison;
    #       data-dependent tier counts, so each tier pool is allocated at full
    #       slot capacity with validity masks.
    #   "quantile": default — static tier counts as fractions of the
    #       selected-token budget; the most-important selected tokens take the
    #       high tier. Deterministic memory, no masks wasted.
    tier_mode: str = "quantile"
    # Fractions of selected slots per tier in quantile mode (high, mid, low).
    # In threshold mode these are the *allocation prior* for the static pool
    # capacities (see threshold_tier_slack).
    tier_fractions: Tuple[float, float, float] = (0.25, 0.5, 0.25)
    # Threshold-mode pool over-allocation factor. Tier membership under
    # theta_h/theta_m is data-dependent, but labels are monotone in score, so
    # in importance-sorted order the tiers are contiguous segments; pools are
    # allocated at ceil(limit · fraction · slack) slots and the segment
    # boundaries clamp to what fits (overflow tokens promote into free
    # higher-tier slots — free quality — or demote when none remain).
    # 1.15 keeps allocated bytes within ~1.2x of quantile mode at equal
    # retention; >= 3.0 reproduces the label-exact reference semantics
    # unconditionally (every tier can hold every selected token).
    threshold_tier_slack: float = 1.15

    # Selection mode:
    #   "topk_prefix": vectorized — sort by importance desc, keep the maximal
    #       prefix whose cumulative byte-cost fits the budget (and at most the
    #       slot capacity). O(S log S).
    #   "exact_greedy": reference-exact greedy incl. the skip-then-refill
    #       refinement (selective_propagation.py:119-131), a sequential
    #       scan over the sorted tokens (ops/selection.py, _greedy_exact).
    selection_mode: str = "topk_prefix"
    # Emergency floor: if the budget selects nothing, keep top
    # max(1, S * fallback_frac) tokens (selective_propagation.py:205-211).
    fallback_frac: float = 0.1

    # Position-bias shape. The reference's b_pos(i) = log(i+1)/log(T)
    # (token_importance.py:93-110) is monotone over the WHOLE sequence, so a
    # fixed beta ranks every late token above every early token once
    # attention-mass differences are smaller than the bias gap — at T >= 1K
    # the gap approaches beta and early-context payloads lose the budget
    # race wholesale (the round-2 committed long-context collapse: token
    # acc 0.13 vs baseline 1.0 at 4K). "recency" (default) replaces it with
    # a windowed ramp b_pos(i) = max(0, 1 - (T - i)/W): recency protects
    # what it is actually for — a local window the next decode steps need —
    # without taxing the early context. W = recency_window tokens
    # (0 → auto: max(64, T // 8), capped at T). "log" restores the exact
    # reference formula (reference_anchor_config pins it).
    position_bias_mode: str = "recency"
    recency_window: int = 0

    # Prompt-region retention floor (beyond the reference): guarantee the
    # first ceil(prompt_len · prompt_region_floor) GLOBAL positions —
    # i.e. that share of the identified prompt region — selection and the
    # HIGH precision tier (the HIGH pool grows to hold anchors, see
    # anchor_count), by boosting their scores above every natural score
    # (but below sink anchors). The reference's own framing says prompt
    # tokens guide importance, yet its formula lets them be dropped at
    # depth; with the floor, instructions/questions at the head of a
    # LongBench-style context survive every layer at full precision. The
    # cost is bounded: the region is at most prompt_cap (128) tokens.
    # Default ON — together with the recency bias this is what holds
    # long-context recall (round-2 collapse fix). 0 disables (reference
    # behavior).
    prompt_region_floor: float = 1.0

    # Observation-window (query-guided) importance source (beyond the
    # reference; SnapKV/H2O-style). The reference's attention term scores
    # token i by how much *i as a query* attends to the prompt region
    # (token_importance.py:21-47) — which cannot find a payload planted at
    # mid-context depth: nothing about a needle makes it attend to the
    # prompt. What CAN find it is the attention the needle *receives* from
    # the trailing queries (the question/instruction at the end of the
    # prompt): retrieval heads at the last positions point straight at the
    # span they need. importance_source selects the mass feeding the alpha
    # term:
    #   "prompt" (default): reference semantics — prompt attention mass.
    #   "query":  observation-window mass — attention each token receives
    #             from the last query_window prefill queries.
    #   "both":   elementwise max of the two normalized masses (protects
    #             prompt-attending tokens AND query-attended spans).
    # query_window: window size W (0 → auto: max(16, min(256, T // 16))).
    # query_mass_pool: max-pool width (tokens) applied to the query mass
    # before normalization. Retrieval attention in trained models is sharp
    # (often one or two positions per span); pooling dilates a hit over its
    # neighborhood so whole spans survive, not just the attended token
    # (SnapKV's pooling, for the same reason). 0 disables.
    # Supported in one-shot and chunked prefill; the sequence-sharded
    # (ring-attention) path supports "prompt" only for now.
    importance_source: str = "prompt"
    query_window: int = 0
    query_mass_pool: int = 0

    # Attention-sink anchors (beyond the reference; AnTKV/StreamingLLM-style):
    # the first `sink_tokens` GLOBAL positions are boosted to the top of the
    # importance ranking, so they are always selected and land in the HIGH
    # tier (threshold mode: boosted above theta_h; quantile mode: top rank).
    # The first few positions accumulate disproportionate attention mass in
    # trained transformers; dropping or crushing them to 2 bits is a known
    # quality cliff at aggressive retention. Keep small (<= 16). 0 disables
    # (reference behavior).
    sink_tokens: int = 0

    # Quantization scale granularity: channels per scale group within a
    # (token, kv_head) vector. 0 → one group per head_dim (per-token-per-head
    # scale). The reference used a single scale across the whole fused
    # kv_heads*head_dim token vector; finer groups strictly improve quality.
    quant_group_size: int = 0
    # Outlier handling: quant range from the (f, 1-f) per-group quantiles
    # instead of absolute min/max; outliers clamp into the clipped range.
    # 0 disables (reference behavior).
    quant_clip_frac: float = 0.0

    # --- decode-token compression (beyond the reference's prefill-only
    # scope): when the uncompressed recent ring fills, its tokens are
    # quantized at decode_pool_bits and flushed into a pool of
    # decode_pool_blocks ring-sized blocks. The pool itself is a ring of
    # blocks: past R*(blocks+1) generated tokens the oldest block is
    # overwritten (sliding window over decode tokens; the compressed prefill
    # pools are never evicted). 0 blocks disables flushing — the ring must
    # then hold the whole generation (round-1 behavior).
    decode_pool_blocks: int = 0
    decode_pool_bits: int = 4

    # Reference parity flag: recompute the prefill attention output against the
    # compressed K (modified_llama.py:125-140). Off by default — keeping the
    # exact prefill output is both faster and higher quality; the compressed
    # cache still fully governs decode.
    recompute_prefill_attention: bool = False

    # Round selected-slot capacities up to this multiple (storage alignment).
    slot_align: int = 8

    # Tokens per sub-byte packing chunk (ops/quantization.pack_codes):
    # strided packing runs independently inside each chunk, so a chunk's
    # byte rows map to a CONTIGUOUS token range — the unit the fused decode
    # kernel unpacks. Tier capacities above this round up to a multiple of
    # it (<= chunk-1 extra masked slots per tier). Small chunks keep the
    # capacity overhead low (~4% at 4K).
    pack_chunk_tokens: int = 128
    # Target tokens per decode-kernel SEGMENT (one grid step): the kernel
    # groups whole chunks per segment up to this size, so grid-step count —
    # and its per-step overhead (~µs each, × layers × steps) — stays low
    # while capacity rounding stays chunk-fine. Must be a multiple of
    # pack_chunk_tokens. The kernel additionally caps each segment's stored
    # bytes (decode_attention._MAX_BLOCK_BYTES) so VMEM blocks stay bounded.
    decode_segment_tokens: int = 2048

    def __post_init__(self):
        for bits in (self.high_precision_bits, self.medium_precision_bits,
                     self.low_precision_bits):
            if bits not in VALID_BITS:
                raise ValueError(f"bit width {bits} not in {VALID_BITS}")
        if not (self.high_precision_bits >= self.medium_precision_bits
                >= self.low_precision_bits):
            raise ValueError("bit tiers must satisfy high >= mid >= low")
        if not (0.0 <= self.theta_m <= self.theta_h):
            raise ValueError("thresholds must satisfy 0 <= theta_m <= theta_h")
        if self.sink_tokens < 0:
            raise ValueError("sink_tokens must be >= 0")
        if self.position_bias_mode not in ("recency", "log"):
            raise ValueError(
                f"unknown position_bias_mode {self.position_bias_mode!r}")
        if self.importance_source not in ("prompt", "query", "both"):
            raise ValueError(
                f"unknown importance_source {self.importance_source!r}")
        if self.query_window < 0:
            raise ValueError("query_window must be >= 0")
        if self.query_mass_pool < 0:
            raise ValueError("query_mass_pool must be >= 0")
        if self.recency_window < 0:
            raise ValueError("recency_window must be >= 0")
        if not (0.0 <= self.prompt_region_floor <= 1.0):
            raise ValueError("prompt_region_floor must be in [0, 1]")
        if self.tier_mode not in ("threshold", "quantile"):
            raise ValueError(f"unknown tier_mode {self.tier_mode!r}")
        if self.selection_mode not in ("topk_prefix", "exact_greedy"):
            raise ValueError(f"unknown selection_mode {self.selection_mode!r}")
        if abs(sum(self.tier_fractions) - 1.0) > 1e-6:
            raise ValueError("tier_fractions must sum to 1")
        if self.threshold_tier_slack < 1.0:
            raise ValueError("threshold_tier_slack must be >= 1.0 "
                             "(pools must hold every selected token)")
        if self.pack_chunk_tokens < 8 or self.pack_chunk_tokens % 4:
            raise ValueError("pack_chunk_tokens must be >= 8 and a multiple "
                             "of 4 (tokens per byte at 2-bit packing)")
        if self.decode_segment_tokens % self.pack_chunk_tokens:
            raise ValueError("decode_segment_tokens must be a multiple of "
                             "pack_chunk_tokens")
        if self.decode_pool_bits not in VALID_BITS:
            raise ValueError(
                f"decode_pool_bits {self.decode_pool_bits} not in {VALID_BITS}")
        if self.decode_pool_blocks < 0:
            raise ValueError("decode_pool_blocks must be >= 0")
        if self.layer_weights is None:
            n = self.num_layers
            if n > 1:
                w = tuple(1.0 - 0.5 * (i / (n - 1)) for i in range(n))
            else:
                w = (1.0,)
            object.__setattr__(self, "layer_weights", w)
        elif len(self.layer_weights) != self.num_layers:
            raise ValueError("layer_weights length must equal num_layers")

    # --- derived static quantities ---

    def tier_bits(self, tier: int) -> int:
        return (self.low_precision_bits, self.medium_precision_bits,
                self.high_precision_bits)[tier]

    def tier_cost(self, tier: int) -> float:
        """Byte-cost per token unit, as in selective_propagation.py:54-58."""
        return self.tier_bits(tier) / 8.0

    def layer_ratio(self, layer_idx: int) -> float:
        """Propagation ratio for a layer (selective_propagation.py:33-38)."""
        early = int(self.early_boundary_frac * self.num_layers)
        middle = int(self.middle_boundary_frac * self.num_layers)
        if layer_idx < early:
            return self.early_layer_ratio
        if layer_idx < middle:
            return self.middle_layer_ratio
        return self.later_layer_ratio

    def prompt_length(self, seq_len: int) -> int:
        """Static prompt prefix length (unified_compressor.py:55)."""
        return max(1, min(int(seq_len * self.prompt_frac), self.prompt_cap))

    def recency_window_for(self, total_len: int) -> int:
        """Static recency-bias window W (position_bias_mode="recency").
        Auto (0): T/4, clamped to [16, 2048]. Why T/4 (measured, round-3
        diagnostics at 4K): the window does double duty — it protects the
        local continuation context AND it concentrates the byte budget's
        LOW-precision tail in the suffix. Too small a window leaves
        scattered mid-sequence tokens holding the 2-bit tier, whose key
        quantization noise attracts spurious attention (acc 0.824 at W=T/8
        vs 0.994 at W=T/4, quality_demo_r3). The floor keeps it off the
        head: a short sequence must not ramp from position 0 (that
        reintroduces the log bias's early-token tax)."""
        w = self.recency_window or max(16, min(2048, total_len // 4))
        return max(1, min(w, total_len))

    def query_window_for(self, total_len: int) -> int:
        """Static observation-window size W (importance_source != "prompt").
        Auto (0): T/16, clamped to [16, 256] — wide enough to cover a
        trailing question/instruction, narrow enough that the dense
        W x S mass computation stays negligible next to prefill."""
        w = self.query_window or max(16, min(256, total_len // 16))
        return max(1, min(w, total_len))

    def prompt_floor_length(self, prompt_len: int) -> int:
        """Static count of head positions guaranteed by prompt_region_floor."""
        if not self.prompt_region_floor:
            return 0
        return min(prompt_len, math.ceil(prompt_len * self.prompt_region_floor))

    def token_limit(self, seq_len: int, layer_idx: int) -> int:
        """Max tokens SELECTED for a layer — exact, bucket-independent
        semantics: ceil(seq_len · ratio), floored by the emergency fraction.
        (For ragged rows the same formula applies to the true length.)"""
        k = math.ceil(seq_len * self.layer_ratio(layer_idx))
        k = max(k, max(1, math.ceil(seq_len * self.fallback_frac)))
        return min(k, seq_len)

    def anchor_count(self, seq_len: int) -> int:
        """Static count of anchored head positions: tokens guaranteed top
        rank AND the HIGH tier — the HIGH tier grows to hold them when the
        fraction prior is too small. Sinks and the prompt floor are both
        head prefixes, so the distinct anchor region is their max."""
        return max(self.sink_tokens,
                   self.prompt_floor_length(self.prompt_length(seq_len)))

    def tier_limits(self, limit: int, anchors: int = 0) -> Tuple[int, int]:
        """Quantile-mode tier boundaries within `limit` selected tokens:
        the top max(ceil(limit·f_h), anchors) are HIGH, the next
        ceil(limit·f_m) MID."""
        fh, fm, _ = self.tier_fractions
        n_h = min(max(math.ceil(limit * fh), anchors), limit)
        n_m = min(math.ceil(limit * fm), limit - n_h)
        return n_h, n_m

    def slot_capacity(self, seq_len: int, layer_idx: int) -> int:
        """Static ALLOCATED selected-token slots (>= token_limit, aligned)."""
        return min(_round_up(self.token_limit(seq_len, layer_idx),
                             self.slot_align), _round_up(seq_len, self.slot_align))

    def tier_capacities(self, seq_len: int, layer_idx: int,
                        grow_for_anchors: bool = True
                        ) -> Tuple[int, int, int]:
        """Static per-tier ALLOCATED pool capacities (high, mid, low).

        Alignment affects only storage; selection counts are governed by
        token_limit/tier_limits, so retention and tier mix are independent
        of padding-bucket choice. `grow_for_anchors=False` (sequence-sharded
        / chunked local selection) keeps the fraction-prior capacities:
        shard capacities must stay uniform and every tier nonzero for the
        slot-axis sharding, so anchors there get selection but only
        best-effort HIGH tier.
        """
        limit = self.token_limit(seq_len, layer_idx)
        cap = _round_up(limit, self.slot_align)
        anchors = (min(self.anchor_count(seq_len), limit)
                   if grow_for_anchors else 0)
        if self.tier_mode == "threshold":
            # Static caps from the allocation prior × slack; selection clamps
            # the (contiguous) tier boundaries to these. Capacity sums to
            # >= limit by construction, so every selected token fits. The
            # HIGH pool additionally grows to hold every anchored token
            # (sinks + prompt floor land above theta_h by construction).
            caps = tuple(
                min(cap, _round_up(max(math.ceil(limit * f
                                                 * self.threshold_tier_slack),
                                       anchors if tier == 0 else 0),
                                   self.slot_align))
                for tier, f in enumerate(self.tier_fractions))
            assert sum(caps) >= limit
            return tuple(self._chunk_align(c) for c in caps)
        n_h, n_m = self.tier_limits(limit, anchors=anchors)
        n_l = limit - n_h - n_m
        return tuple(
            self._chunk_align(_round_up(n, self.slot_align)) if n else 0
            for n in (n_h, n_m, n_l))

    def _chunk_align(self, cap: int) -> int:
        """Capacities above one packing chunk round to a chunk multiple so
        chunked packing (and the decode kernel's segment grid) divides."""
        if cap > self.pack_chunk_tokens:
            return _round_up(cap, self.pack_chunk_tokens)
        return cap

    def tier_chunk(self, capacity: int) -> Optional[int]:
        """Packing chunk for a tier of `capacity` slots (None = one chunk)."""
        if (capacity > self.pack_chunk_tokens
                and capacity % self.pack_chunk_tokens == 0):
            return self.pack_chunk_tokens
        return None


class RopeScaling(NamedTuple):
    """RoPE frequency scaling for long-context checkpoints (hashable, so it
    can live on the frozen ModelConfig).

    kind="linear": positions effectively divided by `factor` (HF "linear").
    kind="llama3": Llama-3.1 scheme — low-frequency bands divided by
      `factor`, high-frequency bands kept, smooth ramp between
      `low_freq_factor` and `high_freq_factor` relative to
      `original_max_position` (HF rope_type "llama3").
    """

    kind: str = "linear"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-family architecture description (RoPE + GQA + RMSNorm + gated
    MLP). Covers Llama/TinyLlama/Mistral (defaults), Qwen2 (`qkv_bias`),
    Gemma (`hidden_act`/`rms_norm_offset`/`scale_embeddings`), and
    long-context variants via `rope_scaling` (Llama-3.1 / linear).

    Counterpart of the dims carried on the reference config
    (base_config.py:10-13) plus what HF's LlamaConfig adds.
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # Family variants:
    qkv_bias: bool = False        # Qwen2: biases on q/k/v projections
    hidden_act: str = "silu"      # gated-MLP activation; Gemma: "gelu_tanh"
    rms_norm_offset: float = 0.0  # Gemma: norms scale by (1 + w), offset=1
    scale_embeddings: bool = False  # Gemma: embeddings * sqrt(hidden_size)
    rope_scaling: Optional[RopeScaling] = None  # long-context RoPE scaling
    # Mixture-of-experts (Mixtral family). num_experts == 0 → dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # MoE execution strategy (ops/moe.py): "auto" picks dynslice for
    # decode-sized token counts (per-routed-expert dynamic slice, no gather
    # materialization), gather up to the weight-traffic crossover, and
    # ragged grouped matmuls beyond; "dense" is the GSPMD expert-parallel
    # form (expert axis sharded over `model`). Explicit values force a path.
    moe_impl: str = "auto"

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim


# Canonical model presets (shapes only; weights load from HF checkpoints).
LLAMA2_7B = ModelConfig()
LLAMA2_13B = ModelConfig(hidden_size=5120, intermediate_size=13824,
                         num_layers=40, num_heads=40, num_kv_heads=40)
TINYLLAMA_1_1B = ModelConfig(hidden_size=2048, intermediate_size=5632,
                             num_layers=22, num_heads=32, num_kv_heads=4,
                             head_dim=64, max_position_embeddings=2048)
# Same decoder family (RoPE + GQA + RMSNorm + SwiGLU); differing dims only.
MISTRAL_7B = ModelConfig(vocab_size=32000, hidden_size=4096,
                         intermediate_size=14336, num_layers=32,
                         num_heads=32, num_kv_heads=8, head_dim=128,
                         max_position_embeddings=32768, rope_theta=1e6)
LLAMA3_8B = ModelConfig(vocab_size=128256, hidden_size=4096,
                        intermediate_size=14336, num_layers=32,
                        num_heads=32, num_kv_heads=8, head_dim=128,
                        max_position_embeddings=8192, rope_theta=500000.0)
# Qwen2: same decoder skeleton + attention-projection biases.
QWEN2_7B = ModelConfig(vocab_size=152064, hidden_size=3584,
                       intermediate_size=18944, num_layers=28,
                       num_heads=28, num_kv_heads=4, head_dim=128,
                       max_position_embeddings=32768, rope_theta=1e6,
                       rms_norm_eps=1e-6, qkv_bias=True)
QWEN2_0_5B = ModelConfig(vocab_size=151936, hidden_size=896,
                         intermediate_size=4864, num_layers=24,
                         num_heads=14, num_kv_heads=2, head_dim=64,
                         max_position_embeddings=32768, rope_theta=1e6,
                         rms_norm_eps=1e-6, qkv_bias=True,
                         tie_word_embeddings=True)
# Gemma (v1): GeGLU MLP, (1 + w) RMSNorm scaling, sqrt(hidden)-scaled
# embeddings, tied LM head, 256-dim heads.
GEMMA_2B = ModelConfig(vocab_size=256000, hidden_size=2048,
                       intermediate_size=16384, num_layers=18,
                       num_heads=8, num_kv_heads=1, head_dim=256,
                       max_position_embeddings=8192, rms_norm_eps=1e-6,
                       tie_word_embeddings=True, hidden_act="gelu_tanh",
                       rms_norm_offset=1.0, scale_embeddings=True)
# Mixtral: Mistral-shaped attention + 8-expert top-2 sparse MLP.
MIXTRAL_8X7B = ModelConfig(vocab_size=32000, hidden_size=4096,
                           intermediate_size=14336, num_layers=32,
                           num_heads=32, num_kv_heads=8, head_dim=128,
                           max_position_embeddings=32768, rope_theta=1e6,
                           num_experts=8, num_experts_per_tok=2)
GEMMA_7B = ModelConfig(vocab_size=256000, hidden_size=3072,
                       intermediate_size=24576, num_layers=28,
                       num_heads=16, num_kv_heads=16, head_dim=256,
                       max_position_embeddings=8192, rms_norm_eps=1e-6,
                       tie_word_embeddings=True, hidden_act="gelu_tanh",
                       rms_norm_offset=1.0, scale_embeddings=True)


def reference_anchor_config(num_layers: int = 32,
                            **overrides) -> CompressionConfig:
    """The reference's committed operating point (VERDICT #5).

    Hyperparameters of the reference's run compression_exp_20251020_225951
    (BASELINE.md): alpha=0.6 beta=0.2 gamma=0.2, theta_h=0.6
    theta_m=0.2, ratios 0.8/0.6/0.4, bits 16/8/4, threshold tier mode.
    At this point the reference measured ~0.45 kept ratio / 55% memory
    savings with dF1 ~ -0.003; benchmark and quality comparisons at the
    reference's own retention should use this config (the byte-cost budget
    with 2.0/1.0/0.5-byte tiers is what pushes kept below the 0.8/0.6/0.4
    token ratios).
    """
    base = dict(alpha=0.6, beta=0.2, gamma=0.2, theta_h=0.6, theta_m=0.2,
                early_layer_ratio=0.8, middle_layer_ratio=0.6,
                later_layer_ratio=0.4, high_precision_bits=16,
                medium_precision_bits=8, low_precision_bits=4,
                tier_mode="threshold", position_bias_mode="log",
                prompt_region_floor=0.0, num_layers=num_layers)
    base.update(overrides)
    return CompressionConfig(**base)


def tiny_test_model(**overrides) -> ModelConfig:
    """A minuscule Llama for CPU unit tests."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
                max_position_embeddings=512, dtype="float32")
    base.update(overrides)
    return ModelConfig(**base)
