"""The port's main path as a whole vs the JAX package's (CPU, float32).

`params_from_jax` carries the JAX `init_params` weights over, so both
packages run the same 2-layer tiny model on the same prompt (numpy seed).
JAX runs `prefill_compressed(use_flash=False)` + `decode_loop(use_fused=
False)` (jitted); the port runs its plain paths on CPU tensors. Checked:
greedy tokens equal for 16 decode steps, prefill logits within 1e-4, every
layer's kept positions and validity identical, packed codes equal up to
the limit below, stats equal, and the uncompressed arm's tokens equal.

Packed codes: upstream float32 values (matmul and RoPE rounding) may differ
in the last bit between the two frameworks, and a value that lands on a
rounding boundary quantizes to the neighbouring code. So the limit is at
most MAX_CODE_FLIPS codes per layer (tests/torch_parity.py), each one
step off; it is checked over several seeds (in 12 seeds, two showed one
such code). The per-op tests
(test_torch_quantization, test_torch_compression) hold packed bytes
byte-identical on identical inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.compression import (
    summarize_layer_stats as j_summary)
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu_torch.compression import (
    summarize_layer_stats as t_summary)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from torch_parity import assert_caches_match, numpy_tree

LAYERS, BATCH, PROMPT, STEPS = 2, 2, 160, 16
ATOL_LOGITS = 1e-4


@pytest.fixture(scope="module")
def runs():
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    jcc = rj.CompressionConfig(num_layers=LAYERS)
    tcc = rt.CompressionConfig(num_layers=LAYERS)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tl.params_from_jax(numpy_tree(jp), device="cpu")
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                            (BATCH, PROMPT))

    pre = jax.jit(lambda p, i: jl.prefill_compressed(
        p, i, jcfg, jcc, max_decode_len=STEPS + 1, use_flash=False))
    loop = jax.jit(lambda p, t, s: jl.decode_loop(
        p, t, s, STEPS, jcfg, jcc, use_fused=False))
    j_logits, j_state, j_stats = pre(jp, jnp.asarray(ids))
    j_toks, _ = loop(jp, jnp.argmax(j_logits, -1), j_state)

    t_logits, t_state, t_stats = tl.prefill_compressed(
        tp, torch.from_numpy(ids), tcfg, tcc, max_decode_len=STEPS + 1)
    t_caches = t_state.caches  # decode mutates only the rings
    t_toks, _ = tl.decode_loop(tp, torch.argmax(t_logits, -1), t_state,
                               STEPS, tcfg, tcc)
    return dict(jcfg=jcfg, tcfg=tcfg, jcc=jcc, tcc=tcc, jp=jp, tp=tp,
                ids=ids, pre=pre, j_logits=j_logits, j_state=j_state,
                j_stats=j_stats, j_toks=j_toks, t_logits=t_logits,
                t_caches=t_caches, t_stats=t_stats, t_toks=t_toks)


def test_greedy_tokens_equal(runs):
    j = np.asarray(runs["j_toks"])
    assert j.shape == (BATCH, STEPS)
    np.testing.assert_array_equal(j, runs["t_toks"].numpy())
    np.testing.assert_array_equal(np.asarray(jnp.argmax(runs["j_logits"],
                                                        -1)),
                                  torch.argmax(runs["t_logits"], -1).numpy())


def test_prefill_logits_close(runs):
    np.testing.assert_allclose(np.asarray(runs["j_logits"]),
                               runs["t_logits"].numpy(), atol=ATOL_LOGITS)


@pytest.mark.parametrize("layer", range(LAYERS))
def test_layer_caches_identical(runs, layer):
    assert_caches_match(runs["j_state"].caches[layer:layer + 1],
                         runs["t_caches"][layer:layer + 1], runs["tcc"])


@pytest.mark.parametrize("seed", [4, 7, 11])
def test_layer_caches_match_across_seeds(runs, seed):
    """Other weights and prompts through the same (compiled) prefill."""
    jp = jl.init_params(jax.random.PRNGKey(seed), runs["jcfg"])
    ids = np.random.default_rng(seed).integers(
        0, runs["jcfg"].vocab_size, (BATCH, PROMPT))
    _, j_state, _ = runs["pre"](jp, jnp.asarray(ids))
    _, t_state, _ = tl.prefill_compressed(
        tl.params_from_jax(numpy_tree(jp), device="cpu"),
        torch.from_numpy(ids),
        runs["tcfg"], runs["tcc"], max_decode_len=STEPS + 1)
    assert_caches_match(j_state.caches, t_state.caches, runs["tcc"])


def test_layer_stats_equal(runs):
    j_sum, t_sum = j_summary(runs["j_stats"]), t_summary(runs["t_stats"])
    assert j_sum.keys() == t_sum.keys()
    for key, val in j_sum.items():
        if isinstance(val, dict):
            assert val == pytest.approx(t_sum[key], rel=1e-6), key
        else:
            assert val == pytest.approx(t_sum[key], rel=1e-6), key
    for js_, ts_ in zip(runs["j_stats"], runs["t_stats"]):
        assert js_.keys() == ts_.keys()
        for key in js_:
            np.testing.assert_allclose(np.asarray(js_[key]),
                                       ts_[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_uncompressed_arm_tokens_equal(runs):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    ids = runs["ids"]
    pad = STEPS + 1

    def arm_j(p, i):
        lo, (ks, vs) = jl.prefill_uncompressed(p, i, jcfg)
        widths = ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))
        kv = (jnp.pad(ks, widths), jnp.pad(vs, widths))
        pos = jnp.full((BATCH,), PROMPT, jnp.int32)
        toks, _, _ = jl.decode_loop_uncompressed(
            p, jnp.argmax(lo, -1), kv, pos, STEPS, jcfg)
        return lo, toks

    j_lo, j_toks = jax.jit(arm_j)(runs["jp"], jnp.asarray(ids))
    t_lo, (ks, vs) = tl.prefill_uncompressed(runs["tp"],
                                             torch.from_numpy(ids), tcfg)
    kv = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
               for a in (ks, vs))
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32)
    t_toks, _, _ = tl.decode_loop_uncompressed(
        runs["tp"], torch.argmax(t_lo, -1), kv, pos, STEPS, tcfg)
    np.testing.assert_allclose(np.asarray(j_lo), t_lo.numpy(),
                               atol=ATOL_LOGITS)
    np.testing.assert_array_equal(np.asarray(j_toks), t_toks.numpy())


def test_recompute_prefill_attention_matches(runs):
    """Reference-parity mode: the prefill output is recomputed against the
    compressed K/V; logits within 1e-4, caches within the limit."""
    jcc = dataclasses.replace(runs["jcc"], recompute_prefill_attention=True)
    tcc = dataclasses.replace(runs["tcc"], recompute_prefill_attention=True)
    ids = runs["ids"]
    j_logits, j_state, _ = jax.jit(lambda p, i: jl.prefill_compressed(
        p, i, runs["jcfg"], jcc, max_decode_len=4))(runs["jp"],
                                                    jnp.asarray(ids))
    t_logits, t_state, _ = tl.prefill_compressed(
        runs["tp"], torch.from_numpy(ids), runs["tcfg"], tcc,
        max_decode_len=4)
    np.testing.assert_allclose(np.asarray(j_logits), t_logits.numpy(),
                               atol=ATOL_LOGITS)
    assert not np.allclose(np.asarray(j_logits),
                           np.asarray(runs["j_logits"]), atol=1e-3)
    assert_caches_match(j_state.caches, t_state.caches, tcc)


def test_generate_is_prefill_then_decode(runs):
    tp, tcfg, tcc = runs["tp"], runs["tcfg"], runs["tcc"]
    out, stats = tl.generate(tp, torch.from_numpy(runs["ids"]), tcfg, tcc,
                             max_new_tokens=STEPS + 1)
    first = torch.argmax(runs["t_logits"], -1)
    np.testing.assert_array_equal(out[:, 0].numpy(), first.numpy())
    np.testing.assert_array_equal(out[:, 1:].numpy(),
                                  runs["t_toks"].numpy())
    assert len(stats) == LAYERS
    eos = int(out[0, 3])
    masked, _ = tl.generate(tp, torch.from_numpy(runs["ids"]), tcfg, tcc,
                            max_new_tokens=STEPS + 1, eos_token_id=eos)
    hit = int((out[0] == eos).nonzero()[0])
    assert (masked[0, hit:] == eos).all()
    assert torch.equal(masked[0, :hit], out[0, :hit])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_params_from_jax_roundtrip(dtype, fused):
    """Every leaf keeps its key, shape, dtype and value, unfused and after
    `fuse_params` on either side."""
    jcfg = rj.tiny_test_model(dtype=dtype, num_layers=2)
    jp = jl.init_params(jax.random.PRNGKey(1), jcfg)
    if fused:
        expect = jl.fuse_params(jp)
        got = tl.fuse_params(tl.params_from_jax(numpy_tree(jp),
                                                device="cpu"))
    else:
        expect, got = jp, tl.params_from_jax(numpy_tree(jp), device="cpu")
    leaves_j, tree_j = jax.tree_util.tree_flatten_with_path(expect)
    leaves_t, tree_t = jax.tree_util.tree_flatten_with_path(got)
    assert tree_j == tree_t
    for (path, a), (_, t) in zip(leaves_j, leaves_t):
        assert tuple(a.shape) == tuple(t.shape), path
        assert str(a.dtype) == str(t.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      t.float().numpy(), err_msg=str(path))


def test_init_params_shapes_and_scale():
    cfg = rt.tiny_test_model(num_layers=2)
    p = tl.init_params(0, cfg, device="cpu")
    assert torch.equal(p["embed"],
                       tl.init_params(0, cfg, device="cpu")["embed"])
    jshapes = jax.eval_shape(lambda: jl.init_params(
        jax.random.PRNGKey(0), rj.tiny_test_model(num_layers=2)))
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes)
    w = p["layers"][0]["w_down"]  # fan_in = intermediate_size = 128
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01


@pytest.mark.parametrize("scaling", [
    None, rt.RopeScaling(kind="linear", factor=4.0),
    rt.RopeScaling(kind="llama3", factor=8.0, original_max_position=64)])
def test_rope_rmsnorm_building_blocks(scaling):
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    js = None if scaling is None else rj.RopeScaling(*scaling)
    cj, sj = jl.rope_tables(jnp.asarray(pos), 16, 10000.0, js)
    ct, st = tl.rope_tables(torch.from_numpy(pos), 16, 10000.0, scaling)
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=1e-5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jl.apply_rope(jnp.asarray(x), cj, sj)),
        tl.apply_rope(torch.from_numpy(x), ct, st).numpy(), atol=1e-5)
    w = rng.normal(size=(16,)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        a = jl.rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                       1e-5)
        b = tl.rmsnorm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt), 1e-5)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_allclose(np.asarray(a.astype(jnp.float32)),
                                   b.float().numpy(), rtol=1e-2, atol=1e-5)


def test_forward_logits_match_jax(runs):
    """All-position logits, plain attention in both packages, within 1e-5;
    the last position is the uncompressed prefill's."""
    jp, tp, ids = runs["jp"], runs["tp"], runs["ids"]
    want = jax.jit(lambda p, i: jl.forward_logits(
        p, i, runs["jcfg"], use_flash=False))(jp, jnp.asarray(ids))
    got = tl.forward_logits(tp, torch.from_numpy(ids), runs["tcfg"])
    assert got.shape == (BATCH, PROMPT, runs["tcfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    last, _ = tl.prefill_uncompressed(tp, torch.from_numpy(ids),
                                      runs["tcfg"])
    np.testing.assert_allclose(got[:, -1].numpy(), last.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_forward_logits_sdpa_route_matches_plain(runs):
    """use_flash runs `scaled_dot_product_attention` (the reference's
    library flash call) at any length: S = 130 is past one of the
    reference's 128-token pad blocks."""
    ids = torch.from_numpy(runs["ids"][:, :130])
    plain = tl.forward_logits(runs["tp"], ids, runs["tcfg"], use_flash=False)
    sdpa = tl.forward_logits(runs["tp"], ids, runs["tcfg"], use_flash=True)
    np.testing.assert_allclose(sdpa.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_unported_paths_raise(runs):
    """Ragged batches, the decode pool, query-guided importance (one-shot
    and chunked: tests/test_torch_query_importance.py) and MoE
    (tests/test_torch_moe.py) are ported; the compressed-prefix prefill
    refuses query-guided scoring, as the reference does. MoE layers get
    the reference's shapes: router gate [H, E], expert stacks [E, H, I] /
    [E, I, H], no dense MLP."""
    tcfg, tcc = runs["tcfg"], runs["tcc"]
    query = dataclasses.replace(tcc, importance_source="query")
    with pytest.raises(ValueError, match="prompt"):
        tl.prefill_chunked_compressed_init(BATCH, PROMPT, 32, tcfg, query,
                                           device="cpu")
    moe_cfg = dataclasses.replace(tcfg, num_experts=4)
    layer = tl.init_params(0, moe_cfg, device="cpu")["layers"][0]
    h, i = moe_cfg.hidden_size, moe_cfg.intermediate_size
    assert "w_gate" not in layer
    assert {k: tuple(v.shape) for k, v in layer["moe"].items()} == {
        "gate": (h, 4), "w_gate": (4, h, i), "w_up": (4, h, i),
        "w_down": (4, i, h)}


def test_gemma_switches_and_head_dim_256_match_jax():
    """A tiny config with Gemma's switches (GeGLU with tanh GELU, (1 + w)
    norms, embeddings scaled by sqrt(hidden), tied head) and its head_dim
    of 256, 2 layers, 2 query heads over 1 kv head: prefill_compressed +
    decode_loop in both packages (JAX jitted, plain paths). Greedy tokens
    equal for 8 steps, prefill logits within ATOL_LOGITS, kept positions
    and validity identical and packed codes under MAX_CODE_FLIPS, as for
    the Llama config above."""
    kw = dict(num_layers=LAYERS, num_heads=2, num_kv_heads=1, head_dim=256,
              tie_word_embeddings=True, hidden_act="gelu_tanh",
              rms_norm_offset=1.0, scale_embeddings=True)
    jcfg, tcfg = rj.tiny_test_model(**kw), rt.tiny_test_model(**kw)
    jcc = rj.CompressionConfig(num_layers=LAYERS)
    tcc = rt.CompressionConfig(num_layers=LAYERS)
    jp = jl.init_params(jax.random.PRNGKey(2), jcfg)
    tp = tl.params_from_jax(numpy_tree(jp), device="cpu")
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (BATCH, 96))
    steps = 8

    def run_j(p, i):
        logits, state, _ = jl.prefill_compressed(
            p, i, jcfg, jcc, max_decode_len=steps + 1, use_flash=False)
        toks, _ = jl.decode_loop(p, jnp.argmax(logits, -1), state, steps,
                                 jcfg, jcc, use_fused=False)
        return logits, state.caches, toks

    j_logits, j_caches, j_toks = jax.jit(run_j)(jp, jnp.asarray(ids))
    t_logits, t_state, _ = tl.prefill_compressed(
        tp, torch.from_numpy(ids), tcfg, tcc, max_decode_len=steps + 1)
    t_caches = t_state.caches
    t_toks, _ = tl.decode_loop(tp, torch.argmax(t_logits, -1), t_state,
                               steps, tcfg, tcc)
    np.testing.assert_allclose(np.asarray(j_logits), t_logits.numpy(),
                               atol=ATOL_LOGITS)
    np.testing.assert_array_equal(np.asarray(j_toks), t_toks.numpy())
    assert_caches_match(j_caches, t_caches, tcc)
