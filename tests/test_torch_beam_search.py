"""The port's beam search vs the JAX package's (CPU, float32).

Same weights (the port's `init_params` from a seed, fed to JAX through
`jax_tree`) and the same prompts (numpy seed) go through JAX's
`beam_search(use_fused_decode=False)` (the plain decode path, which JAX's
own tests hold equal to its Pallas kernel) and the port's: every beam's
sequence exactly equal and its score within 1e-5, at W = 1 and 3, B = 2,
with and without an EOS the model emits (the best first token of row 0, so
that beam freezes at step 0 and survives the search), at length_penalty 0
and 1. Then the port alone: W = 1 equals `generate`, the score equals the
teacher-forced log-probability through `decode_step` (as JAX's
`test_score_matches_teacher_forced_logprob`), and the search leaves the
prefill's state unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import beam_search as jb
from realtime_kv_cache_compression_tpu_torch.models import beam_search as tb
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from torch_parity import jax_tree

T = 8
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = rj.tiny_test_model(num_layers=2)
    tcfg = rt.tiny_test_model(num_layers=2)
    tp = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 64))
    return (jcfg, rj.CompressionConfig(num_layers=2), tcfg,
            rt.CompressionConfig(num_layers=2), jax_tree(tp), tp, ids)


def _eos(model):
    """Row 0's best first token: the model emits it at step 0."""
    _, _, tcfg, tccfg, _, tp, ids = model
    seqs, _, _ = tb.beam_search(tp, torch.from_numpy(ids), tcfg, tccfg,
                                num_beams=3, max_new_tokens=T)
    return int(seqs[0, 0])


@pytest.mark.parametrize("num_beams,use_eos,length_penalty", [
    (1, False, 1.0), (3, False, 1.0), (3, True, 0.0), (3, True, 1.0)])
def test_beams_match_jax(model, num_beams, use_eos, length_penalty):
    jcfg, jccfg, tcfg, tccfg, jp, tp, ids = model
    eos = _eos(model) if use_eos else None
    kw = dict(num_beams=num_beams, max_new_tokens=T,
              length_penalty=length_penalty, eos_token_id=eos)
    j_seqs, j_scores, _ = jb.beam_search(jp, jnp.asarray(ids), jcfg, jccfg,
                                         use_fused_decode=False,
                                         return_all_beams=True, **kw)
    t_seqs, t_scores, _ = tb.beam_search(tp, torch.from_numpy(ids), tcfg,
                                         tccfg, return_all_beams=True, **kw)
    np.testing.assert_array_equal(np.asarray(j_seqs), t_seqs.numpy())
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               rtol=TOL, atol=TOL)
    best, best_score, _ = tb.beam_search(tp, torch.from_numpy(ids), tcfg,
                                         tccfg, **kw)
    assert torch.equal(best, t_seqs[:, 0])
    assert torch.equal(best_score, t_scores[:, 0])
    if use_eos:  # row 0's first beam froze at step 0, padded with EOS
        rows = t_seqs[0].tolist()
        assert [eos] * T in rows
        for row in rows:
            if eos in row:
                assert row[row.index(eos):] == [eos] * (T - row.index(eos))


def test_one_beam_equals_generate(model):
    _, _, tcfg, tccfg, _, tp, ids = model
    ids = torch.from_numpy(ids)
    greedy, _ = tl.generate(tp, ids, tcfg, tccfg, max_new_tokens=T)
    beams, scores, _ = tb.beam_search(tp, ids, tcfg, tccfg, num_beams=1,
                                      max_new_tokens=T)
    assert torch.equal(greedy, beams) and scores.shape == (2,)


def test_score_matches_teacher_forced_logprob(model):
    _, _, tcfg, tccfg, _, tp, ids = model
    ids = torch.from_numpy(ids[:1])
    beams, scores, _ = tb.beam_search(tp, ids, tcfg, tccfg, num_beams=3,
                                      max_new_tokens=T)
    seq = beams[0].tolist()
    logits, state, _ = tl.prefill_compressed(tp, ids, tcfg, tccfg,
                                             max_decode_len=T)
    total = float(torch.log_softmax(logits.float(), -1)[0, seq[0]])
    for tok, nxt in zip(seq, seq[1:]):
        logits, state = tl.decode_step(tp, torch.tensor([tok]), state, tcfg,
                                       tccfg)
        total += float(torch.log_softmax(logits.float(), -1)[0, nxt])
    assert abs(float(scores[0]) * T - total) < 1e-4, (float(scores[0]), total)


def test_search_leaves_the_prefill_state_unchanged(model):
    _, _, tcfg, _, _, tp, ids = model
    tccfg = rt.CompressionConfig(num_layers=2, decode_pool_blocks=2,
                                 decode_pool_bits=4)
    logits, state, _ = tl.prefill_compressed(tp, torch.from_numpy(ids), tcfg,
                                             tccfg, max_decode_len=4)
    before = [t.clone() for t in tl.decode_state_tensors(state)]
    seqs, _ = tb._search(tp, logits, state, tcfg, tccfg, 3, 3 * 4 + 2, 1.0,
                         None, None)
    assert seqs.shape == (2, 3, 14)
    assert state.ring_fill == (0, 0)
    for a, b in zip(before, tl.decode_state_tensors(state), strict=True):
        assert torch.equal(a, b)
