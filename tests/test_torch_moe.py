"""The port's MoE layer vs the JAX package's (CPU, tiny widths).

Same float32 weights and tokens (numpy seeds) through both packages'
`ops/moe.py`: the router's ids exactly and its weights within 1e-6; every
strategy (ragged, gather, dynslice, dense) and the per-expert oracle
within 1e-5 of JAX's in float32; int8 and int4 expert stacks
byte-identical to JAX's, with every strategy held to the dequantized
oracle at JAX's own tolerances (tests/test_moe.py: 1e-4 int8, 1e-2 int4);
`quantize_params` and `quantize_params_streaming` on a MoE tree
byte-identical; a 2-layer MoE model with int4 experts generating the same
kept positions and tokens as JAX's; and the "auto" rule's choice at N =
1, 8, 9 and 17 tokens.

Router ties: a last-bit difference upstream of the router could swap two
experts whose probabilities are nearly equal, and the output would move by
a whole expert. The inputs here are fed to both packages as the same
float32 values, and `_margin` asserts that every kept expert leads the
first dropped one by more than 1e-6, so a swap cannot hide behind these
seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models import quantized_params as jq
from realtime_kv_cache_compression_tpu.ops import moe as jm
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models import (
    quantized_params as tq)
from realtime_kv_cache_compression_tpu_torch.ops import moe as tm

from torch_parity import jax_tree, numpy_tree

STRATEGIES = ("ragged", "gather", "dynslice", "dense")
TOL = {"float": 1e-5, "int8": 1e-4, "int4": 1e-2}
EXPERT_QUANTIZERS = {
    "int8": (jq.quantize_expert_tensor, tq.quantize_expert_tensor),
    "int4": (lambda w: jq.quantize_expert_tensor_int4(w, group_size=16),
             lambda w: tq.quantize_expert_tensor_int4(w, group_size=16))}


def _cfgs(**over):
    kw = dict(num_experts=4, num_experts_per_tok=2, **over)
    return rj.tiny_test_model(**kw), rt.tiny_test_model(**kw)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    moe = tl.init_params(0, tcfg, device="cpu")["layers"][0]["moe"]
    x = np.random.default_rng(1).normal(
        size=(2, 12, tcfg.hidden_size)).astype(np.float32)
    return jcfg, tcfg, moe, x


def _margin(x2, gate, k) -> float:
    """Smallest lead of a kept expert's probability over the first
    dropped one."""
    probs = torch.softmax(torch.from_numpy(x2) @ gate, -1)
    top = torch.topk(probs, k + 1, -1).values
    return float((top[:, k - 1] - top[:, k]).min())


def _close(j, t, tol, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol,
                               rtol=0, err_msg=what)


def test_router_topk_matches_jax(setup):
    jcfg, _, moe, x = setup
    x2 = x.reshape(-1, x.shape[-1])
    assert _margin(x2, moe["gate"], jcfg.num_experts_per_tok) > 1e-6
    jw, jids = jm.router_topk(jnp.asarray(x2), jnp.asarray(moe["gate"]), 2)
    tw, tids = tm.router_topk(torch.from_numpy(x2), moe["gate"], 2)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(jw, tw, 1e-6, "router weights")


def test_router_topk_exact_ties_match_jax(setup):
    """Exactly equal probabilities (three zero gate columns, and a zero
    token whose experts all tie): the lower expert id first, as
    jax.lax.top_k orders them."""
    _, _, moe, x = setup
    x2 = x.reshape(-1, x.shape[-1]).copy()
    x2[0] = 0.0
    gate = torch.zeros_like(moe["gate"])
    gate[:, 2] = moe["gate"][:, 2]
    jw, jids = jm.router_topk(jnp.asarray(x2), jnp.asarray(gate.numpy()), 2)
    tw, tids = tm.router_topk(torch.from_numpy(x2), gate, 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert set(tids[:, 1].tolist()) <= {0, 1}  # ties resolved to the lowest
    _close(jw, tw, 1e-6, "router weights")


def test_float_strategies_and_oracle_match_jax(setup):
    jcfg, tcfg, moe, x = setup
    jmoe = jax_tree(moe)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(jm.moe_mlp_reference(jmoe, jx, jcfg),
           tm.moe_mlp_reference(moe, tx, tcfg), TOL["float"], "oracle")
    for impl in STRATEGIES:
        _close(jm.moe_mlp(jmoe, jx, jcfg, impl=impl),
               tm.moe_mlp(moe, tx, tcfg, impl=impl), TOL["float"], impl)


def _same(a, t):
    a = np.asarray(a)
    assert str(a.dtype) == str(t.dtype).replace("torch.", "")
    assert a.shape == tuple(t.shape)
    np.testing.assert_array_equal(a.view(np.uint8), t.numpy().view(np.uint8))


def _same_expert(j, t):
    if isinstance(j, jq.Int4ExpertTensor):
        assert isinstance(t, tq.Int4ExpertTensor)
        assert (j.in_dim, j.group_size) == (t.in_dim, t.group_size)
        _same(j.q_packed, t.q_packed)
    else:
        assert isinstance(t, tq.QuantizedExpertTensor)
        _same(j.q, t.q)
    _same(j.scale, t.scale)


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_quantized_experts_identical_and_track_oracle(setup, bits):
    """Stacks byte-identical to JAX's; every strategy within JAX's
    tolerance of the dequantized oracle; the dynslice strategy (K3's
    expert GEMV in int4, bf16 input on both sides) within it of JAX's."""
    jcfg, tcfg, moe, x = setup
    jquant, tquant = EXPERT_QUANTIZERS[bits]
    keys = ("w_gate", "w_up", "w_down")
    jmoe = {k: jquant(jnp.asarray(v.numpy())) if k in keys
            else jnp.asarray(v.numpy()) for k, v in moe.items()}
    tmoe = {k: tquant(v) if k in keys else v for k, v in moe.items()}
    for k in keys:
        _same_expert(jmoe[k], tmoe[k])
    np.testing.assert_array_equal(
        np.asarray(jmoe["w_up"].dequantize(jnp.float32)),
        tmoe["w_up"].dequantize(torch.float32).numpy())
    tx, tx1 = torch.from_numpy(x), torch.from_numpy(x[:, :2])
    want = tm.moe_mlp_reference(tmoe, tx, tcfg)
    for impl in ("ragged", "gather", "dense"):
        _close(want, tm.moe_mlp(tmoe, tx, tcfg, impl=impl), TOL[bits], impl)
    # dynslice on 4 tokens (decode-sized), as JAX's test runs it.
    got = tm.moe_mlp(tmoe, tx1, tcfg, impl="dynslice")
    _close(tm.moe_mlp_reference(tmoe, tx1, tcfg), got, TOL[bits], "dynslice")
    # Against JAX's on one token, jitted (its int4 form runs the Pallas
    # kernel in interpret mode: one compile instead of six eager ones).
    j_dyn = jax.jit(lambda m, xx: jm.moe_mlp(m, xx, jcfg, impl="dynslice"))
    _close(j_dyn(jmoe, jnp.asarray(x[:1, :1])), got[:1, :1], TOL[bits],
           "dynslice vs JAX")


def test_quantize_moe_trees_identical():
    """`quantize_params` (bits 4 and 8) and `quantize_params_streaming` of
    a 2-layer MoE tree, byte for byte; the byte and weight counts."""
    jcfg, tcfg = _cfgs(num_layers=2)
    params = tl.init_params(0, tcfg, device="cpu")
    for kw in (dict(bits=4, group_size=16), dict(bits=8)):
        j = jq.quantize_params(jax_tree(params), **kw)
        t = tq.quantize_params(params, **kw)
        for jl_, tl_ in zip(j["layers"], t["layers"]):
            for k in ("w_gate", "w_up", "w_down"):
                _same_expert(jl_["moe"][k], tl_["moe"][k])
            _same(jl_["moe"]["gate"], tl_["moe"]["gate"])
            assert type(jl_["wq"]).__name__ == type(tl_["wq"]).__name__
        assert tq.params_are_quantized(t)
        assert tq.params_bytes(t) == jq.params_bytes(j)
        assert tq.params_num_weights(t) == jq.params_num_weights(j)
        streamed = tq.quantize_params_streaming(
            tl.init_params(0, tcfg, device="cpu"), **kw)
        for a, b in zip(t["layers"], streamed["layers"]):
            for k in ("w_gate", "w_up", "w_down"):
                for f in ("q", "q_packed", "scale"):
                    if hasattr(a["moe"][k], f):
                        assert torch.equal(getattr(a["moe"][k], f),
                                           getattr(b["moe"][k], f))


def test_generate_int4_moe_matches_jax():
    """2 layers, int4 experts (group 16) and int4 attention matmuls:
    `prefill_compressed` (the ragged strategy over dequantized experts)
    then greedy decode (dynslice: K3's expert GEMV on the card, its plain
    version here; JAX's Pallas kernel in interpret mode). Kept positions
    and tokens equal."""
    jcfg, tcfg = _cfgs(num_layers=2)
    jcc = rj.CompressionConfig(num_layers=2)
    tcc = rt.CompressionConfig(num_layers=2)
    tp = tl.fuse_params(tq.quantize_params(
        tl.init_params(0, tcfg, device="cpu"), bits=4, group_size=16))
    assert "wq" in tp["layers"][0] and "moe" in tp["layers"][0]
    jp = jax_tree(tp)
    ids = np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 48))
    steps = 5

    def run_j(p, i):
        logits, state, _ = jl.prefill_compressed(
            p, i, jcfg, jcc, max_decode_len=steps + 1, use_flash=False)
        toks, _ = jl.decode_loop(p, jnp.argmax(logits, -1), state, steps,
                                 jcfg, jcc, use_fused=False)
        return jnp.argmax(logits, -1), toks, state

    j_first, j_toks, j_state = jax.jit(run_j)(jp, jnp.asarray(ids))
    t_logits, t_state, _ = tl.prefill_compressed(
        tp, torch.from_numpy(ids), tcfg, tcc, max_decode_len=steps + 1)
    t_first = torch.argmax(t_logits, -1)
    t_toks, _ = tl.decode_loop(tp, t_first, t_state, steps, tcfg, tcc)
    for jc, tc in zip(numpy_tree(j_state.caches), t_state.caches):
        for a, b in zip(jc.tiers, tc.tiers):
            np.testing.assert_array_equal(a.positions, b.positions.numpy())
    np.testing.assert_array_equal(np.asarray(j_first), t_first.numpy())
    np.testing.assert_array_equal(np.asarray(j_toks), t_toks.numpy())


def test_auto_rule(setup, monkeypatch):
    """"auto": dynslice at N <= 8 (int4 stacks stay packed), gather at N
    <= 16, ragged beyond (int4 stacks dequantized up front)."""
    _, tcfg, moe, x = setup
    qmoe = {k: tq.quantize_expert_tensor_int4(v, group_size=16)
            if k != "gate" else v for k, v in moe.items()}
    seen = []
    for impl in STRATEGIES:
        real = getattr(tm, f"_moe_{impl}")
        monkeypatch.setattr(
            tm, f"_moe_{impl}",
            lambda m, *a, _i=impl, _r=real: seen.append(
                (_i, isinstance(m["w_up"], tq.Int4ExpertTensor))) or
            _r(m, *a))
    x2 = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    for n in (1, 8, 9, 17):
        tm.moe_mlp(qmoe, x2[:n], tcfg)
    assert seen == [("dynslice", True), ("dynslice", True),
                    ("gather", False), ("ragged", False)]
