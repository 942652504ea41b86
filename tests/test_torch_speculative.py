"""The port's speculative decoding vs the JAX package's (CPU, float32).

One prefill by the port feeds both packages (`state_to_jax`), with the
port's weights (`jax_tree`), so the decoders start from the same state.
JAX's loops run its plain decode path (`use_fused=False`, which its own
tests hold equal to its Pallas kernel); `verify_forward` reaches no kernel
in either package.

- `propose_prompt_lookup` equal to JAX's on its cases and on ragged rows.
- `speculative_decode_loop` tokens equal JAX's `decode_loop` and the
  port's (which JAX's tests hold equal to JAX's speculative tokens): B=3
  ragged prompts, n_draft 1 and 3.
- With decode pools (ring 8, 3 blocks at 8 bits, 30 steps: several
  flushes): tokens, positions, ring lengths and the pools' codes, scales,
  positions and validity equal to JAX's `speculative_decode_loop` state
  (ring values within 1e-5: projections of a block in the two frameworks),
  and the oracle proposer's iteration count ceil(30 / 4).
- `adaptive_speculative_decode` with prompt-lookup and adversarial drafts
  (probe_every 100 and 2): tokens and the arms trace equal to JAX's.
- `commit_block` on given block K/V with gates that leave rows behind and
  rings that fill inside the block: rings and pools equal to JAX's.
- `extend_prefill` of a ragged suffix longer than the ring: last logits
  within 1e-5 of JAX's, rings and pools as JAX commits them, the input
  state unchanged.

Runs that share one state copy it first (`clone_decode_state`): the
port's decoders update rings and pools in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models import speculative as js
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models import speculative as ts
from torch_parity import jax_tree, state_to_jax

TOL = 1e-5
RING = 8
RING_FIELDS = ("positions", "length")
POOL_CODES = ("k_stored", "v_stored", "positions", "valid", "write_block")
POOL_AFFINE = ("k_scale", "k_zp", "v_scale", "v_zp")


def _ccfgs(**kw):
    kw = dict(num_layers=2, high_precision_bits=8, medium_precision_bits=4,
              low_precision_bits=2, **kw)
    return rj.CompressionConfig(**kw), rt.CompressionConfig(**kw)


@pytest.fixture(scope="module")
def model():
    jcfg = rj.tiny_test_model(num_layers=2)
    tcfg = rt.tiny_test_model(num_layers=2)
    tp = tl.init_params(0, tcfg, device="cpu")
    return jcfg, tcfg, jax_tree(tp), tp


def _prefill(model, ccfg, b, s, max_decode_len, lengths=None, seed=0):
    """The port's prefill of a numpy prompt: (ids, lengths, first tokens,
    state); ragged rows are zero past their length."""
    _, tcfg, _, tp = model
    ids = np.random.default_rng(seed).integers(0, tcfg.vocab_size, (b, s))
    if lengths is not None:
        ids = np.where(np.arange(s)[None] < np.array(lengths)[:, None], ids,
                       0)
        lengths = torch.tensor(lengths, dtype=torch.int32)
    ids = torch.from_numpy(ids)
    logits, state, _ = tl.prefill_compressed(
        tp, ids, tcfg, ccfg, max_decode_len=max_decode_len, lengths=lengths)
    return ids, lengths, torch.argmax(logits, -1), state


def _assert_same(obj_j, obj_t, fields, what):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(obj_j, f)),
                                      getattr(obj_t, f).numpy(),
                                      err_msg=f"{what}.{f}")


def _assert_rings_and_pools(state_j, state_t, affine_rtol=TOL):
    """Ring positions and lengths, pool codes, positions, validity and
    `write_block` equal; ring values within TOL (the K/V projections of a
    block in the two frameworks); pool scales and zero points within
    `affine_rtol` relative (they follow the ring values)."""
    for rj_, rt_ in zip(state_j.recents, state_t.recents, strict=True):
        _assert_same(rj_, rt_, RING_FIELDS, "ring")
        for f in ("k", "v"):
            live = int(np.asarray(rj_.length).max())
            np.testing.assert_allclose(
                getattr(rt_, f)[:, :live].numpy(),
                np.asarray(getattr(rj_, f))[:, :live], rtol=TOL, atol=TOL)
    for pj, pt in zip(state_j.pools, state_t.pools, strict=True):
        if pj is None:
            continue
        _assert_same(pj, pt, POOL_CODES, "pool")
        for f in POOL_AFFINE:
            np.testing.assert_allclose(
                getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                rtol=affine_rtol, atol=0, err_msg=f"pool.{f}")


def test_prompt_lookup_matches_jax():
    prompt = np.array([[1, 7, 8, 9, 10, 11, 3, 7, 8]])
    cases = [(prompt, [9], [[7, 8]], 3), (prompt, [9], [[99, 98]], 3),
             (prompt, [5], [[8, 9]], 3)]
    rng = np.random.default_rng(2)
    ragged = rng.integers(0, 6, (4, 40))  # few symbols: many matches
    cases.append((ragged, [40, 31, 7, 2], ragged[[0, 1, 2, 3], [9, 4, 5, 0]
                                                  ][:, None].repeat(2, 1),
                  5))
    cases.append((ragged, [40, 31, 17, 12], ragged[:, 10:12], 4))
    lookup = jax.jit(js.propose_prompt_lookup, static_argnums=3)
    for ids, lens, last2, n in cases:
        want = lookup(jnp.asarray(ids, jnp.int32),
                      jnp.asarray(lens, jnp.int32),
                      jnp.asarray(last2, jnp.int32), n)
        got = ts.propose_prompt_lookup(
            torch.tensor(ids), torch.tensor(lens), torch.tensor(last2), n)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.fixture(scope="module")
def ragged_run(model):
    """B=3 ragged prompts, 16 steps: JAX's decode_loop tokens."""
    jcfg, _, jp, _ = model
    cj, ct = _ccfgs()
    ids, lengths, first, state = _prefill(model, ct, 3, 80, 48,
                                          lengths=[80, 57, 64])
    ref = jax.jit(lambda p, f, s: jl.decode_loop(
        p, f, s, 16, jcfg, cj, use_fused=False)[0])(
            jp, jnp.asarray(first.numpy()), state_to_jax(state))
    return ct, ids, lengths, first, state, np.asarray(ref)


@pytest.mark.parametrize("n_draft", [1, 3])
def test_tokens_equal_decode_loop(model, ragged_run, n_draft):
    _, tcfg, _, tp = model
    ct, ids, lengths, first, state, ref = ragged_run
    toks, _ = tl.decode_loop(tp, first, tl.clone_decode_state(state), 16,
                             tcfg, ct)
    np.testing.assert_array_equal(toks.numpy(), ref)
    toks, _, stats = ts.speculative_decode_loop(
        tp, first, tl.clone_decode_state(state), 16, tcfg, ct,
        prompt_ids=ids, prompt_lens=lengths, n_draft=n_draft)
    np.testing.assert_array_equal(toks.numpy(), ref)
    assert 1 <= stats["iterations"] <= 16


def test_pooled_state_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    cj, ct = _ccfgs(decode_pool_blocks=3, decode_pool_bits=8)
    n_steps, n_draft = 30, 3
    ids, _, first, state = _prefill(model, ct, 2, 96, 8, seed=1)
    toks_j, state_j, stats_j = jax.jit(
        lambda p, f, s, i: js.speculative_decode_loop(
            p, f, s, n_steps, jcfg, cj, prompt_ids=i, n_draft=n_draft))(
        jp, jnp.asarray(first.numpy()), state_to_jax(state),
        jnp.asarray(ids.numpy()))
    ref, ref_state = tl.decode_loop(tp, first, tl.clone_decode_state(state),
                                    n_steps, tcfg, ct)
    toks, state_t, stats = ts.speculative_decode_loop(
        tp, first, tl.clone_decode_state(state), n_steps, tcfg, ct,
        prompt_ids=ids, n_draft=n_draft)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(toks_j))
    np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    assert stats["iterations"] == int(stats_j["iterations"])
    assert stats["drafted_accepted"] == int(stats_j["drafted_accepted"])
    np.testing.assert_array_equal(state_t.position.numpy(),
                                  np.asarray(state_j.position))
    assert list(state_t.ring_fill) == state_t.recents[0].length.tolist()
    assert state_t.ring_fill == ref_state.ring_fill
    _assert_rings_and_pools(state_j, state_t)
    # The oracle proposer (the reference tokens) emits n_draft + 1 a
    # forward; the ring's end (8 = 2 x 4) cuts no block short.
    def oracle(last2, count, out):
        cols = count[:, None] + torch.arange(n_draft)[None]
        return torch.gather(ref, 1, torch.clamp(cols, max=n_steps - 1))

    toks, _, stats = ts.speculative_decode_loop(
        tp, first, tl.clone_decode_state(state), n_steps, tcfg, ct,
        prompt_ids=ids, n_draft=n_draft, proposer=oracle)
    assert torch.equal(toks, ref)
    assert stats["iterations"] == -(-n_steps // (n_draft + 1))


def test_adaptive_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    cj, ct = _ccfgs()
    n_steps, n_draft, chunk = 48, 3, 8
    ids, _, first, state = _prefill(model, ct, 1, 64, 96, seed=2)

    def adversarial_j(last2, count, out):
        return jnp.broadcast_to((last2[:, 1:2] + 1) % jcfg.vocab_size,
                                (last2.shape[0], n_draft))

    def adversarial_t(last2, count, out):
        return ((last2[:, 1:2] + 1) % tcfg.vocab_size).expand(-1, n_draft)

    for proposers, probe_every in (((None, None), 4),
                                   ((adversarial_j, adversarial_t), 100),
                                   ((adversarial_j, adversarial_t), 2)):
        kw = dict(n_draft=n_draft, chunk=chunk, probe_every=probe_every)
        toks_j, _, stats_j = js.adaptive_speculative_decode(
            jp, jnp.asarray(first.numpy()), state_to_jax(state), n_steps,
            jcfg, cj, prompt_ids=jnp.asarray(ids.numpy()),
            proposer=proposers[0], **kw)
        toks, _, stats = ts.adaptive_speculative_decode(
            tp, first, tl.clone_decode_state(state), n_steps, tcfg, ct,
            prompt_ids=ids, proposer=proposers[1], **kw)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(toks_j))
        assert stats["arms"] == stats_j["arms"]
        for key in ("forwards", "spec_chunks", "plain_chunks"):
            assert stats[key] == stats_j[key], key
        assert stats["draft_rate"] == pytest.approx(stats_j["draft_rate"])
    assert stats["spec_chunks"] >= 2 and stats["plain_chunks"] >= 1


def _ring_state(model, ccfg, fills, seed):
    """A 2-row state whose rings (capacity 8) hold `fills` tokens of given
    K/V, with an 8-bit pool of 2 blocks."""
    _, tcfg, _, _ = model
    _, _, _, state = _prefill(model, ccfg, len(fills), 32, RING, seed=seed)
    rng = np.random.default_rng(seed)
    for r in state.recents:
        for t in (r.k, r.v):
            t.copy_(torch.from_numpy(rng.normal(size=t.shape)
                                     .astype(np.float32)))
        r.positions.copy_(torch.arange(RING, dtype=torch.int32) + 32)
        r.length.copy_(torch.tensor(fills, dtype=torch.int32))
    return tl.dataclasses.replace(state, position=state.position
                                  + torch.tensor(fills, dtype=torch.int32),
                                  ring_fill=tuple(fills))


def test_commit_block_with_gates_matches_jax(model):
    """Row 0 keeps all 5 tokens from fill 7 (its ring fills at j = 0 and
    flushes at j = 1); row 1 keeps 2 from fill 6, so its ring fills at its
    last kept token and flushes at j = 2, past its keep. JAX runs eagerly
    here: pool bytes, scales and zero points are equal."""
    jcfg, tcfg, _, _ = model
    cj, ct = _ccfgs(decode_pool_blocks=2, decode_pool_bits=8)
    state = _ring_state(model, ct, (7, 6), seed=3)
    rng = np.random.default_rng(4)
    blocks = [tuple(rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    keep = np.array([5, 2], np.int32)
    state_j = js.commit_block(
        state_to_jax(state), [tuple(map(jnp.asarray, b)) for b in blocks],
        jnp.asarray(keep), jcfg, cj)
    state_t = ts.commit_block(
        state, [tuple(map(torch.from_numpy, b)) for b in blocks],
        torch.from_numpy(keep), tcfg, ct, host_keep=keep.tolist())
    np.testing.assert_array_equal(state_t.position.numpy(),
                                  np.asarray(state_j.position))
    assert list(state_t.ring_fill) == np.asarray(
        state_j.recents[0].length).tolist() == [4, 0]
    _assert_rings_and_pools(state_j, state_t, affine_rtol=0)
    for rj_, rt_ in zip(state_j.recents, state_t.recents):
        np.testing.assert_array_equal(rt_.k.numpy(), np.asarray(rj_.k))


def test_extend_prefill_matches_jax(model, monkeypatch):
    """A suffix of 12 over a ring of 8, lengths (12, 8): row 0 flushes at
    j = 8, and row 1 too, past its keep (its ring filled at its last
    token). JAX's `extend_prefill` runs its `verify_forward` jitted (an
    eager one compiles op by op, about 7 s) and its commit eagerly."""
    jcfg, tcfg, jp, tp = model
    monkeypatch.setattr(js, "verify_forward", jax.jit(
        js.verify_forward, static_argnums=(3, 4)))
    cj, ct = _ccfgs(decode_pool_blocks=2, decode_pool_bits=8)
    _, _, _, state = _prefill(model, ct, 2, 32, RING, seed=5)
    suffix = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 12))
    lens = np.array([12, 8], np.int32)
    last_j, state_j = js.extend_prefill(
        jp, state_to_jax(state), jnp.asarray(suffix), jnp.asarray(lens),
        jcfg, cj)
    before = [t.clone() for t in tl.decode_state_tensors(state)]
    last, state_t = ts.extend_prefill(tp, state, torch.from_numpy(suffix),
                                      torch.from_numpy(lens), tcfg, ct)
    np.testing.assert_allclose(last.numpy(), np.asarray(last_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(state_t.position.numpy(),
                                  np.asarray(state_j.position))
    assert state_t.ring_fill == (4, 0)
    _assert_rings_and_pools(state_j, state_t)
    for a, b in zip(before, tl.decode_state_tensors(state), strict=True):
        assert torch.equal(a, b)
    assert state.ring_fill == (0, 0)
