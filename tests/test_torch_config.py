"""PyTorch port's config vs the JAX package's: fields, defaults, presets,
validation and every derived method must agree exactly (pure Python on
both sides, so the tolerance is zero)."""

import dataclasses

import pytest

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt

SEQ_LENS = (1, 2, 3, 7, 64, 100, 127, 128, 129, 200, 1000, 1024, 4096,
            4100, 32768)

COMPRESSION_CASES = {
    "default": {},
    "tiers_16_8_4": dict(high_precision_bits=16, medium_precision_bits=8,
                         low_precision_bits=4),
    "threshold": dict(tier_mode="threshold", threshold_tier_slack=1.5),
    "sinks_no_floor": dict(sink_tokens=4, prompt_region_floor=0.0),
    "half_floor_log_bias": dict(prompt_region_floor=0.5,
                                position_bias_mode="log"),
    "small_chunks": dict(pack_chunk_tokens=16, decode_segment_tokens=64),
    "odd_fractions": dict(tier_fractions=(0.3, 0.3, 0.4),
                          fallback_frac=0.05, slot_align=16),
    "layers_7": dict(num_layers=7, recency_window=50, prompt_cap=64),
}


def _pair(overrides):
    return (rj.CompressionConfig(**overrides),
            rt.CompressionConfig(**overrides))


def test_constants_match():
    for name in ("HIGH", "MID", "LOW"):
        assert getattr(rt, name) == getattr(rj, name)
    from realtime_kv_cache_compression_tpu import config as jc
    from realtime_kv_cache_compression_tpu_torch import config as tc
    assert tc.VALID_BITS == jc.VALID_BITS
    assert tc.TIER_NAMES == jc.TIER_NAMES


@pytest.mark.parametrize("case", sorted(COMPRESSION_CASES))
def test_compression_fields_match(case):
    a, b = _pair(COMPRESSION_CASES[case])
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("case", sorted(COMPRESSION_CASES))
def test_compression_derived_methods_match(case):
    a, b = _pair(COMPRESSION_CASES[case])
    for tier in (rj.LOW, rj.MID, rj.HIGH):
        assert a.tier_bits(tier) == b.tier_bits(tier)
        assert a.tier_cost(tier) == b.tier_cost(tier)
    for s in SEQ_LENS:
        assert a.prompt_length(s) == b.prompt_length(s)
        assert a.recency_window_for(s) == b.recency_window_for(s)
        assert a.query_window_for(s) == b.query_window_for(s)
        assert a.anchor_count(s) == b.anchor_count(s)
        assert a.prompt_floor_length(a.prompt_length(s)) == \
            b.prompt_floor_length(b.prompt_length(s))
        for layer in range(a.num_layers):
            assert a.layer_ratio(layer) == b.layer_ratio(layer)
            assert a.token_limit(s, layer) == b.token_limit(s, layer)
            assert a.slot_capacity(s, layer) == b.slot_capacity(s, layer)
            for grow in (True, False):
                caps = a.tier_capacities(s, layer, grow_for_anchors=grow)
                assert caps == b.tier_capacities(s, layer,
                                                 grow_for_anchors=grow)
                for cap in caps:
                    assert a.tier_chunk(cap) == b.tier_chunk(cap)
            limit = a.token_limit(s, layer)
            assert a.tier_limits(limit, anchors=a.anchor_count(s)) == \
                b.tier_limits(limit, anchors=b.anchor_count(s))


@pytest.mark.parametrize("bad", [
    dict(high_precision_bits=3), dict(low_precision_bits=8),
    dict(theta_m=0.9), dict(sink_tokens=-1),
    dict(position_bias_mode="linear"), dict(importance_source="x"),
    dict(query_window=-1), dict(prompt_region_floor=1.5),
    dict(tier_mode="exact"), dict(selection_mode="greedy"),
    dict(tier_fractions=(0.5, 0.5, 0.5)), dict(threshold_tier_slack=0.9),
    dict(pack_chunk_tokens=6), dict(decode_segment_tokens=100),
    dict(decode_pool_bits=5), dict(decode_pool_blocks=-1),
    dict(layer_weights=(1.0, 0.5)),
])
def test_compression_validation_matches(bad):
    with pytest.raises(ValueError) as ja:
        rj.CompressionConfig(**bad)
    with pytest.raises(ValueError) as tb:
        rt.CompressionConfig(**bad)
    assert str(ja.value) == str(tb.value)


@pytest.mark.parametrize("name", [
    "LLAMA2_7B", "LLAMA2_13B", "TINYLLAMA_1_1B", "MISTRAL_7B", "LLAMA3_8B",
    "MIXTRAL_8X7B"])
def test_model_presets_match(name):
    a, b = getattr(rj, name), getattr(rt, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.kv_dim, a.q_dim) == (b.kv_dim, b.q_dim)


def test_other_presets_and_helpers_match():
    from realtime_kv_cache_compression_tpu import config as jc
    from realtime_kv_cache_compression_tpu_torch import config as tc
    for name in ("QWEN2_7B", "QWEN2_0_5B", "GEMMA_2B", "GEMMA_7B"):
        assert dataclasses.asdict(getattr(jc, name)) == \
            dataclasses.asdict(getattr(tc, name))
    for kw in ({}, dict(num_layers=22, tier_mode="quantile")):
        assert dataclasses.asdict(rj.reference_anchor_config(**kw)) == \
            dataclasses.asdict(rt.reference_anchor_config(**kw))
    for kw in ({}, dict(num_layers=2, dtype="bfloat16")):
        assert dataclasses.asdict(rj.tiny_test_model(**kw)) == \
            dataclasses.asdict(rt.tiny_test_model(**kw))
    scaling = dict(kind="llama3", factor=8.0)
    assert tuple(rj.RopeScaling(**scaling)) == tuple(rt.RopeScaling(**scaling))
