"""The quantized-weight path as a whole vs the JAX package's (CPU, float32).

A 2-layer tiny model is quantized in JAX (`quantize_params`, then
`fuse_params`) in each arm: int4 (`bits=4`, group 16 at hidden 64, every
layer matmul an `Int4Tensor`, embed and lm_head int8) and W8A8 (`bits=8,
act_quant=True`, every layer matmul and lm_head through the int8 matmul).
Init, quantization and fusion run under one `jax.jit` per arm (one
compile; XLA's codes may differ in the last bit from eager JAX's, which
does not matter here: `params_from_jax` carries the tree over, so both
packages run the same codes and scales). JAX runs `prefill_compressed(use_flash=False)` +
`decode_loop(use_fused=False)` jitted; the port runs its plain paths on CPU
tensors. Checked: prefill logits within ATOL_LOGITS, greedy tokens equal
for STEPS decode steps.

Tolerance 1e-4, as the unquantized parity test. The int4 arm's matmuls
are the same grouped float32 sums in both packages, so the logits differ
by float32 reassociation: max 2.1e-6 at this seed, at most 5.8e-6 over
weight seeds 0-5 (prompt seed + 1). The W8A8 arm's integer products are
exact, but a last-bit difference upstream can put an activation on the
other side of a rounding boundary and move its int8 code by one: at this
seed (weights 0, prompt 1) the logits differ by up to 2.3e-5, at seeds
1-5 by at most 1.4e-6. Greedy tokens were equal at all twelve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models.quantized_params import (
    quantize_params)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models.quantized_params import (
    Int4Tensor, QuantizedTensor)

LAYERS, BATCH, PROMPT, STEPS = 2, 2, 96, 8
ATOL_LOGITS = 1e-4
ARMS = {"int4": dict(bits=4, group_size=16),
        "w8a8": dict(bits=8, act_quant=True)}


@pytest.fixture(scope="module", params=sorted(ARMS))
def arm(request):
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    jcc = rj.CompressionConfig(num_layers=LAYERS)
    tcc = rt.CompressionConfig(num_layers=LAYERS)
    jp = jax.jit(lambda key: jl.fuse_params(quantize_params(
        jl.init_params(key, jcfg), **ARMS[request.param])))(
            jax.random.PRNGKey(0))
    tp = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                            (BATCH, PROMPT))

    def run_j(p, i):
        logits, state, _ = jl.prefill_compressed(
            p, i, jcfg, jcc, max_decode_len=STEPS + 1, use_flash=False)
        toks, _ = jl.decode_loop(p, jnp.argmax(logits, -1), state, STEPS,
                                 jcfg, jcc, use_fused=False)
        return logits, toks

    j_logits, j_toks = jax.jit(run_j)(jp, jnp.asarray(ids))
    t_logits, state, _ = tl.prefill_compressed(
        tp, torch.from_numpy(ids), tcfg, tcc, max_decode_len=STEPS + 1)
    t_toks, _ = tl.decode_loop(tp, torch.argmax(t_logits, -1), state, STEPS,
                               tcfg, tcc)
    return dict(name=request.param, tp=tp, j_logits=np.asarray(j_logits),
                j_toks=np.asarray(j_toks), t_logits=t_logits, t_toks=t_toks)


def test_quantized_leaves_carried_over(arm):
    layer = arm["tp"]["layers"][0]
    assert set(layer) >= {"wqkv", "wo", "w_gateup", "w_down"}
    assert isinstance(arm["tp"]["embed"], QuantizedTensor)
    assert arm["tp"]["embed"].axis == 0
    if arm["name"] == "int4":
        assert all(isinstance(layer[k], Int4Tensor)
                   for k in ("wqkv", "wo", "w_gateup", "w_down"))
        assert not arm["tp"]["lm_head"].act_quant
    else:
        assert all(isinstance(layer[k], QuantizedTensor) and layer[k].act_quant
                   for k in ("wqkv", "wo", "w_gateup", "w_down"))
        assert arm["tp"]["lm_head"].act_quant


def test_prefill_logits_close(arm):
    np.testing.assert_allclose(arm["j_logits"], arm["t_logits"].numpy(),
                               atol=ATOL_LOGITS)


def test_greedy_tokens_equal(arm):
    assert arm["j_toks"].shape == (BATCH, STEPS)
    np.testing.assert_array_equal(arm["j_toks"], arm["t_toks"].numpy())
    np.testing.assert_array_equal(arm["j_logits"].argmax(-1),
                                  arm["t_logits"].argmax(-1).numpy())


def test_tied_quantized_embedding_logits():
    """Tied head over the per-row int8 embedding (logits_from_hidden)."""
    jcfg = rj.tiny_test_model(num_layers=1, tie_word_embeddings=True)
    tcfg = rt.tiny_test_model(num_layers=1, tie_word_embeddings=True)
    jp = jax.jit(lambda key: quantize_params(jl.init_params(key, jcfg)))(
        jax.random.PRNGKey(2))
    tp = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    h = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jl.logits_from_hidden(p, x, jcfg))(
        jp, jnp.asarray(h)))
    got = tl.logits_from_hidden(tp, torch.from_numpy(h), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
