"""Decode from the sequence-sharded state with no gather (CPU, float32,
gloo ranks) against the JAX package's decode over the gathered state.

A 2-layer `tiny_test_model` (the port's `init_params` weights feed both
packages), B=2 rows of S=128 tokens from a seeded numpy draw. Ranks run
as spawned processes over a gloo group (`parallel.launch.run_ranks`, the
rank side `tests/torch_ranks.sharded_decode_runs`), once per world size (2
and 4) for the whole file. Each rank runs
`seq_parallel_prefill(sharded_compression=True)`, then decodes 4 greedy
tokens from its own slot shard (`decode_step(slot_group=...)`: the plain
version of K2's lse mode over the shard, the ring and decode pool on rank
0 only, the partials merged over the group), in two arms: rings that hold
every decode token, and a 2-token ring flushing into a 2-block decode
pool. JAX's `decode_loop` over the gathered state is the reference, as
`tests/test_sharded_compression.py:136` holds JAX's own sharded decode:
- the tokens equal, on every rank;
- the step logits within 1e-4 of JAX's `decode_step` over that state;
- the decode issued no gather of the tiers: its only all-gathers are one
  a layer and step, of the (o, lse) partials; each rank's tiers hold 1/n
  of the slots before and after the steps;
- `decode_attention_plain(return_lse=True)` against a dense log-softmax
  over the same dequantized keys: lse within 1e-5 on a row with keys, and
  at most -1e30 on a row that sees none; its output equal to the default
  call's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu_torch.compression.compressor import \
    dequantize_layer_cache
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
    import decode_attention_plain
from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

import torch_ranks
from torch_parity import jax_tree, state_to_jax

LAYERS, B, S, STEPS = 2, 2, 128, 4
TOL_LOGITS, TOL_LSE = 1e-4, 1e-5
# arm -> (decode_pool_blocks, ring capacity)
ARMS = {"ring": (0, STEPS + 4), "pooled": (2, 2)}


@pytest.fixture(scope="module")
def setup():
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    params = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, S))
    runs = {arm: (rt.CompressionConfig(num_layers=LAYERS,
                                       decode_pool_blocks=blocks), ring)
            for arm, (blocks, ring) in ARMS.items()}
    ranks = {n: run_ranks(torch_ranks.sharded_decode_runs, n, args=(
        params, torch.from_numpy(ids), tcfg, runs, STEPS), timeout=240)
        for n in (2, 4)}
    return dict(tcfg=tcfg, runs=runs, jp=jax_tree(params), ranks=ranks)


@functools.lru_cache(maxsize=None)
def _jit(arm):
    jcfg = rj.tiny_test_model(num_layers=LAYERS)
    ccfg = rj.CompressionConfig(num_layers=LAYERS,
                                decode_pool_blocks=ARMS[arm][0])
    loop = jax.jit(lambda p, t, s: jl.decode_loop(p, t, s, STEPS, jcfg,
                                                  ccfg))
    step = jax.jit(lambda p, t, s: jl.decode_step(p, t, s, jcfg, ccfg))
    return loop, step


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arm", list(ARMS))
def test_sharded_decode_matches_jax_over_gathered_state(setup, n, arm):
    ranks = setup["ranks"][n]
    loop, step = _jit(arm)
    res0 = ranks[0][arm]
    first = jnp.asarray(res0["tokens"][:, 0].numpy())
    want_toks, _ = loop(setup["jp"], first, state_to_jax(res0["full"]))
    tok, state, want_logits = first, state_to_jax(res0["full"]), []
    for _ in range(STEPS):
        lg, state = step(setup["jp"], tok, state)
        tok = jnp.argmax(lg, -1)
        want_logits.append(np.asarray(lg))
    for rank, res in enumerate(ranks):
        got = res[arm]
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                      np.asarray(want_toks),
                                      err_msg=str(rank))
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.stack(want_logits), atol=TOL_LOGITS,
                                   rtol=0, err_msg=str(rank))
        # The tiers never moved: one all-gather a layer and step, of the
        # (o, lse) partials.
        hq, d = setup["tcfg"].num_heads, setup["tcfg"].head_dim
        assert got["gathers"] == [[(B, 1, hq, d), (B, hq, 1)]] * (
            LAYERS * STEPS), got["gathers"][:3]
        before, after = got["slots"]
        full = [[t.positions.shape[1] for t in c.tiers]
                for c in got["full"].caches]
        assert before == after
        assert [[x * n for x in layer] for layer in before] == full
        assert torch.equal(got["ring_len"], ranks[0][arm]["ring_len"])


def test_plain_lse_matches_dense_log_softmax(setup):
    """The plain version's lse mode over a gathered layer-0 cache and a
    seeded q: lse against a dense log-softmax of the same dequantized keys
    (row 0 at the state's position sees keys; row 1 at position -1 sees
    none), o equal to the default call's."""
    tcfg, ccfg = setup["tcfg"], setup["runs"]["ring"][0]
    full = setup["ranks"][2][0]["ring"]["full"]
    cache, recent = full.caches[0], full.recents[0]
    gen = np.random.default_rng(4)
    q = torch.from_numpy(gen.standard_normal(
        (B, 1, tcfg.num_heads, tcfg.head_dim)).astype(np.float32))
    q_pos = torch.tensor([[S], [-1]], dtype=torch.int32)
    o, lse = decode_attention_plain(q, cache, recent, q_pos, ccfg,
                                    return_lse=True)
    assert torch.equal(o, decode_attention_plain(q, cache, recent, q_pos,
                                                 ccfg))
    k, _, pos, valid = dequantize_layer_cache(cache, ccfg, torch.float32)
    rep = tcfg.num_heads // tcfg.num_kv_heads
    logits = torch.einsum("bhd,bkhd->bhk", q[:, 0],
                          k.repeat_interleave(rep, dim=2))
    logits = logits / tcfg.head_dim ** 0.5
    seen = valid & (pos <= S)  # row 0's keys (the ring is empty)
    want = torch.logsumexp(torch.where(seen[:, None], logits, -torch.inf), -1)
    np.testing.assert_allclose(lse[0, :, 0].numpy(), want[0].numpy(),
                               atol=TOL_LSE, rtol=0)
    assert bool((lse[1] <= -1e30).all())
    assert bool((o[1] == 0).all())
