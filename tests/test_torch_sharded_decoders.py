"""Beam search, speculative decoding, `extend_prefill` and the sharded
engine's registered prefixes over a sharded tree (CPU, float32, gloo
ranks) against the JAX package's one-device functions.

A 2-layer `tiny_test_model` (the port's `init_params` weights feed both
packages), B=2 prompts of 64 tokens from a seeded numpy draw whose
second half repeats the first (so prompt lookup drafts are accepted).
Ranks run as spawned processes over a gloo group
(`parallel.launch.run_ranks`, the rank side
`tests/torch_ranks.sharded_decoder_runs`), once per mesh: (1, 2) and
(2, 2) (data x model; on 2 x 2 each data rank holds one prompt). On every
rank:
- `beam_search` (W=3, 6 tokens, EOS the model emits first on row 0):
  every beam's sequence equal to JAX's `beam_search`, scores within 1e-4
  relative;
- `speculative_decode_loop` (prompt lookup, 3 drafts, 8 steps) from the
  sharded prefill: tokens equal to JAX's `decode_loop` from its prefill;
- `extend_prefill` of a ragged suffix (lengths 6 and 4): last logits
  within 2e-4 of JAX's `extend_prefill` over its own prefill (the
  tensor-parallel prefill's limit, `tests/test_torch_sharding.py`), the
  positions equal, the rank's rows and kv heads of the ring within 1e-5
  of JAX's;
- on 2 x 2, a sharded `ServingEngine` that registers a 40-token prefix
  serves a prompt extending it (a partial hit through the sharded
  `extend_prefill`) and an unrelated one with the tokens of a one-rank
  engine;
- on 2 x 2, `beam_search` of one prompt raises ValueError naming the
  rule (its beams would be split over the data ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import beam_search as jb
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models import speculative as js
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks
from realtime_kv_cache_compression_tpu_torch.serving.engine import \
    ServingEngine

import torch_ranks
from torch_parity import jax_tree

LAYERS, B, S = 2, 2, 64
BEAM = dict(num_beams=3, max_new_tokens=6)
SPEC = (8, 3)  # n_steps, n_draft
SUFFIX_LENS = (6, 4)
ENGINE = dict(num_slots=2, context_len=64, max_new_tokens=6, decode_chunk=3,
              prefix_cache_size=4, prefix_continue_budget=16)
PREFIX = 40
TOL_SCORE, TOL_EXTEND, TOL_RING = 1e-4, 2e-4, 1e-5
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def setup():
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    ccfg = rt.CompressionConfig(num_layers=LAYERS)
    params = tl.init_params(0, tcfg, device="cpu")
    rng = np.random.default_rng(7)
    ids = rng.integers(0, tcfg.vocab_size, (B, S))
    ids[:, S // 2:] = ids[:, :S // 2]
    suffix = rng.integers(0, tcfg.vocab_size, (B, max(SUFFIX_LENS)))
    # EOS: row 0's best first token, which the model emits at step 0.
    logits, _, _ = tl.prefill_compressed(params, torch.from_numpy(ids),
                                         tcfg, ccfg)
    beam = dict(BEAM, eos_token_id=int(torch.argmax(logits[0])))
    prompts = [ids[0, :PREFIX].tolist() + ids[1, :8].tolist(),
               ids[1, 10:40].tolist()]
    engine = (ENGINE, ids[0, :PREFIX].tolist(), prompts)
    ranks = {shape: run_ranks(torch_ranks.sharded_decoder_runs,
                              shape[0] * shape[1], args=(
        shape, params, tcfg, ccfg, torch.from_numpy(ids), beam, SPEC,
        (torch.from_numpy(suffix), torch.tensor(SUFFIX_LENS)),
        engine if shape == (2, 2) else None), timeout=240)
        for shape in MESHES}
    return dict(tcfg=tcfg, ccfg=ccfg, params=params, jp=jax_tree(params),
                jcfg=rj.tiny_test_model(num_layers=LAYERS),
                jccfg=rj.CompressionConfig(num_layers=LAYERS), ids=ids,
                suffix=suffix, beam=beam, engine=engine, ranks=ranks)


@pytest.fixture(scope="module")
def jax_prefill(setup):
    """JAX's one-device prefill of the prompts, with ring room."""
    return jax.jit(lambda p, i: jl.prefill_compressed(
        p, i, setup["jcfg"], setup["jccfg"], max_decode_len=16))(
            setup["jp"], jnp.asarray(setup["ids"]))


@pytest.mark.parametrize("shape", MESHES)
def test_beam_search_matches_jax(setup, shape):
    j_seqs, j_scores, _ = jb.beam_search(
        setup["jp"], jnp.asarray(setup["ids"]), setup["jcfg"],
        setup["jccfg"], use_fused_decode=False, return_all_beams=True,
        **setup["beam"])
    for rank, res in enumerate(setup["ranks"][shape]):
        seqs, scores = res["beam"]
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(j_seqs),
                                      err_msg=str(rank))
        np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores),
                                   rtol=TOL_SCORE, atol=0)


@pytest.mark.parametrize("shape", MESHES)
def test_speculative_tokens_equal_jax_decode_loop(setup, jax_prefill,
                                                  shape):
    logits, state, _ = jax_prefill
    first = jnp.argmax(logits, -1)
    toks, _ = jax.jit(lambda p, t, s: jl.decode_loop(
        p, t, s, SPEC[0], setup["jcfg"], setup["jccfg"]))(setup["jp"], first,
                                                          state)
    want = np.concatenate([np.asarray(first)[:, None], np.asarray(toks)], 1)
    for rank, res in enumerate(setup["ranks"][shape]):
        got, stats = res["spec"]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(rank))
        assert stats["drafted_accepted"] > 0  # drafts were committed


@pytest.mark.parametrize("shape", MESHES)
def test_extend_prefill_matches_jax(setup, jax_prefill, shape):
    _, state, _ = jax_prefill
    verify = jax.jit(js.verify_forward, static_argnums=(3, 4))
    orig, js.verify_forward = js.verify_forward, verify
    try:
        last_j, state_j = js.extend_prefill(
            setup["jp"], state, jnp.asarray(setup["suffix"]),
            jnp.asarray(np.array(SUFFIX_LENS, np.int32)), setup["jcfg"],
            setup["jccfg"])
    finally:
        js.verify_forward = orig
    ring_j = np.asarray(state_j.recents[0].k)
    for rank, res in enumerate(setup["ranks"][shape]):
        last, position, ring_k, ring_len = res["extend"]
        np.testing.assert_allclose(last.numpy(), np.asarray(last_j),
                                   atol=TOL_EXTEND, rtol=0)
        np.testing.assert_array_equal(position.numpy(),
                                      np.asarray(state_j.position)[
                                          res["row0"]:res["row0"]
                                          + position.shape[0]])
        rows = slice(res["row0"], res["row0"] + ring_k.shape[0])
        heads = slice(*res["kv_heads"])
        np.testing.assert_allclose(ring_k.numpy(), ring_j[rows, :, heads],
                                   atol=TOL_RING, rtol=0)
        np.testing.assert_array_equal(
            ring_len.numpy(), np.asarray(state_j.recents[0].length)[rows])


def test_sharded_engine_partial_prefix_hit_matches_one_rank(setup):
    kw, prefix, prompts = setup["engine"]
    eng = ServingEngine(setup["params"], setup["tcfg"], setup["ccfg"], **kw)
    eng.register_prefix(prefix)
    rids = [eng.submit(p) for p in prompts]
    done = eng.run()
    want = [done[r].tokens for r in rids]
    assert eng.prefix_partial_hits == 1
    for rank, res in enumerate(setup["ranks"][(2, 2)]):
        tokens, partial_hits = res["engine"]
        assert partial_hits == 1, rank
        assert tokens == want, rank


def test_beam_split_over_data_ranks_raises(setup):
    for res in setup["ranks"][(2, 2)]:
        assert res["refused"] is not None
        assert "whole prompts" in res["refused"], res["refused"]
    assert all(res["refused"] is None for res in setup["ranks"][(1, 2)])
