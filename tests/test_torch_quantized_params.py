"""The port's quantized weights vs the JAX package's (CPU).

Same float32 weights (numpy seeds) through both packages' quantizers:
int8 codes, int4 packed bytes and every scale must be byte-identical
(both compute absmax / 127 or / 7, divide and round half-to-even in the
same float32 order). Checked per tensor (per-row embedding, per-column
weights, grouped and single-group int4), per tree (`quantize_params` in
all three modes, `quantize_params_streaming`, `fuse_params` of a quantized
tree) and for the byte and weight counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models import quantized_params as jq
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models import (
    quantized_params as tq)


def _w(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _same(a, t):
    """A JAX array and a torch tensor hold identical bytes."""
    a = np.asarray(a)
    assert str(a.dtype) == str(t.dtype).replace("torch.", ""), (a.dtype,
                                                                 t.dtype)
    assert a.shape == tuple(t.shape)
    np.testing.assert_array_equal(a.view(np.uint8), t.numpy().view(np.uint8))


def _same_leaf(j, t):
    if isinstance(j, jq.QuantizedTensor):
        assert isinstance(t, tq.QuantizedTensor)
        assert (j.axis, j.act_quant) == (t.axis, t.act_quant)
        _same(j.q, t.q)
        _same(j.scale, t.scale)
    elif isinstance(j, jq.Int4Tensor):
        assert isinstance(t, tq.Int4Tensor)
        assert j.in_dim == t.in_dim and j.group_size == t.group_size
        _same(j.q_packed, t.q_packed)
        _same(j.scale, t.scale)
    else:
        _same(j, t)


def _same_tree(j, t):
    if isinstance(j, dict):
        assert j.keys() == t.keys()
        for k in j:
            _same_tree(j[k], t[k])
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same_tree(a, b)
    else:
        _same_leaf(j, t)


@pytest.mark.parametrize("shape,axis,act_quant", [
    ((256, 64), 0, False),   # embedding: per-row scale
    ((64, 192), 1, False),   # weight-only, per out-channel
    ((128, 64), 1, True),    # W8A8 weight
])
def test_int8_codes_and_scales_identical(shape, axis, act_quant):
    w = _w(1, shape)
    j = jq.quantize_tensor(jnp.asarray(w), axis=axis, act_quant=act_quant)
    t = tq.quantize_tensor(torch.from_numpy(w), axis=axis,
                           act_quant=act_quant)
    _same_leaf(j, t)
    np.testing.assert_array_equal(np.asarray(j.dequantize(jnp.float32)),
                                  t.dequantize(torch.float32).numpy())


@pytest.mark.parametrize("shape,group_size,n_g", [
    ((64, 128), 16, 4),      # hidden 64, group 16: grouped
    ((256, 48), 128, 2),     # default group, two groups
    ((100, 40), 128, 1),     # 100 % 256 != 0: single-group fallback
])
def test_int4_packed_bytes_and_scales_identical(shape, group_size, n_g):
    w = _w(2, shape)
    j = jq.quantize_tensor_int4(jnp.asarray(w), group_size=group_size)
    t = tq.quantize_tensor_int4(torch.from_numpy(w), group_size=group_size)
    assert t.scale.shape[0] == n_g
    _same_leaf(j, t)
    _same(j.unpack_codes(), t.unpack_codes())
    np.testing.assert_array_equal(np.asarray(j.dequantize(jnp.float32)),
                                  t.dequantize(torch.float32).numpy())


def test_int4_odd_in_dim_rejected():
    with pytest.raises(ValueError, match="even"):
        tq.quantize_tensor_int4(torch.zeros((7, 4)))


@pytest.fixture(scope="module")
def trees():
    """One float32 tree in each package, from the port's seeded init (the
    JAX package's eager init would compile each of its ops first)."""
    tp = tl.init_params(3, rt.tiny_test_model(num_layers=2), device="cpu")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    return jp, tp


@pytest.mark.parametrize("bits,act_quant,group_size", [
    (8, False, 128), (8, True, 128), (4, False, 16)])
def test_quantize_params_trees_identical(trees, bits, act_quant, group_size):
    jp, tp = trees
    kw = dict(bits=bits, act_quant=act_quant, group_size=group_size)
    jq_tree = jq.quantize_params(jp, **kw)
    tq_tree = tq.quantize_params(tp, **kw)
    _same_tree(jq_tree, tq_tree)
    # Streaming consumes a copy of the tree and gives the same result.
    copy = {k: v for k, v in tp.items() if k != "layers"}
    copy["layers"] = [dict(layer) for layer in tp["layers"]]
    _same_tree(jq_tree, tq.quantize_params_streaming(copy, **kw))
    assert copy["embed"] is None and copy["layers"] == [None, None]
    # fuse_params of the quantized tree, in each package.
    _same_tree(jl.fuse_params(jq_tree), tl.fuse_params(tq_tree))
    assert tq.params_are_quantized(tq_tree)
    assert not tq.params_are_quantized(tp)
    assert jq.params_bytes(jq_tree) == tq.params_bytes(tq_tree)
    assert (jq.params_num_weights(jq_tree)
            == tq.params_num_weights(tq_tree))


def test_params_from_jax_carries_quantized_leaves(trees):
    jp, _ = trees
    jq_tree = jl.fuse_params(jq.quantize_params(jp, bits=4, group_size=16))
    got = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jq_tree),
                             device="cpu")
    _same_tree(jq_tree, got)
    _same_tree(jq_tree, tq.params_to(got, torch.device("cpu")))


def test_quantize_params_guards(trees):
    _, tp = trees
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params(tp, bits=3)
    streamed = {**tp, "layers": list(tp["layers"])}
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params_streaming(streamed, bits=3)
    assert streamed["embed"] is tp["embed"]  # refused before any was consumed
    # MoE layers quantize their expert stacks (tests/test_torch_moe.py).
    moe_cfg = rt.tiny_test_model(num_layers=1, num_experts=4)
    q = tq.quantize_params(tl.init_params(0, moe_cfg, device="cpu"), bits=4,
                           group_size=16)
    assert isinstance(q["layers"][0]["moe"]["w_up"], tq.Int4ExpertTensor)
    cfg = rt.tiny_test_model(num_layers=1)
    assert tq.params_bytes(tl.init_params(0, cfg, device="cpu")) > 0
