"""The port's sampler and sampled decode vs the JAX package (CPU, float32).

The filters (top-k, top-p, min-p) and the penalties on given tie-free
logits: equal outputs, so the masks are exact. `sample_logits` on the
Gumbel noise JAX drew for the same key (`jax.random.categorical` is
argmax(logits + gumbel(key))): equal tokens; the two packages' random
streams differ, so the port's own draws are held only to what a seeded
generator fixes (the same seed, the same tokens; top-k 1 is greedy).
`decode_loop` with penalties, `return_counts` and `return_logprobs` on a
2-layer tiny model with the JAX package's weights: equal greedy tokens,
equal counts, logprobs within 1e-5 (float32 log-softmax of logits the two
frameworks sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import sampling as js
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops import sampling as ts
from torch_parity import jax_tree

ATOL_LOGPROBS = 1e-5
B, V = 4, 96


def _logits(seed):
    """Tie-free logits [B, V] (a permutation of spaced values per row)."""
    rng = np.random.default_rng(seed)
    base = np.linspace(-6.0, 6.0, V, dtype=np.float32)
    return np.stack([rng.permutation(base) for _ in range(B)]
                    ) + rng.normal(scale=1e-3, size=(B, V)).astype(np.float32)


def _counts(seed):
    rng = np.random.default_rng(seed)
    counts = np.zeros((B, V), np.int32)
    counts[:, rng.integers(0, V, 12)] = rng.integers(1, 4, 12)
    return counts


@pytest.mark.parametrize("name,arg", [
    ("top_k", 10), ("top_k", 1), ("top_p", 0.9), ("top_p", 0.3),
    ("min_p", 0.05)])
def test_filters_match_jax(name, arg):
    x = _logits(1) / 0.8
    want = np.asarray(getattr(js, f"apply_{name}")(jnp.asarray(x), arg))
    got = getattr(ts, f"apply_{name}")(torch.from_numpy(x), arg).numpy()
    np.testing.assert_array_equal(got == ts.NEG_INF, want == js.NEG_INF)
    np.testing.assert_array_equal(got, want)
    assert 0 < int((got == ts.NEG_INF).sum()) < B * V or arg == 1


@pytest.mark.parametrize("params", [
    dict(repetition_penalty=1.3),
    dict(presence_penalty=0.5, frequency_penalty=0.25),
    dict(repetition_penalty=0.8, presence_penalty=-0.2,
         frequency_penalty=0.1)])
def test_penalties_match_jax(params):
    x, counts = _logits(2), _counts(3)
    want = js.apply_penalties(jnp.asarray(x), jnp.asarray(counts),
                              js.SamplingParams(**params))
    got = ts.apply_penalties(torch.from_numpy(x), torch.from_numpy(counts),
                             ts.SamplingParams(**params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_counts_match_jax():
    toks = np.array([3, 3, 95, 0], np.int32)
    want = js.update_counts(js.init_counts(B, V, jnp.asarray(toks)),
                            jnp.asarray(toks[::-1].copy()))
    seeded = ts.init_counts(B, V, torch.from_numpy(toks))
    got = ts.update_counts(seeded, torch.from_numpy(toks[::-1].copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(seeded.sum()) == B  # update_counts leaves its input as it was


@pytest.mark.parametrize("params", [
    dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.1),
    dict(temperature=1.3, min_p=0.02, presence_penalty=0.4),
    dict(temperature=0.7)])
def test_sample_logits_on_jax_noise(params):
    x, counts = _logits(4), _counts(5)
    pj, pt = js.SamplingParams(**params), ts.SamplingParams(**params)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = js.sample_logits(jnp.asarray(x), key, pj,
                                counts=jnp.asarray(counts))
        g = np.array(jax.random.gumbel(key, (B, V), jnp.float32))
        logits = torch.from_numpy(x)
        if pt.uses_penalties:
            logits = ts.apply_penalties(logits, torch.from_numpy(counts), pt)
        got = ts._sample_with_noise(logits, torch.from_numpy(g), pt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_logits_with_a_generator():
    x = torch.from_numpy(_logits(6))
    p = ts.SamplingParams(temperature=0.8, top_k=50, top_p=0.9)
    draw = lambda seed, params=p: ts.sample_logits(  # noqa: E731
        x, torch.Generator().manual_seed(seed), params)
    assert torch.equal(draw(1), draw(1))
    assert torch.equal(draw(2, p._replace(top_k=1)), torch.argmax(x, -1))
    with pytest.raises(ValueError):
        ts.sample_logits(x, None, p)


@pytest.fixture(scope="module")
def model():
    layers = 2
    jcfg, tcfg = (rj.tiny_test_model(num_layers=layers),
                  rt.tiny_test_model(num_layers=layers))
    cj, ct = (rj.CompressionConfig(num_layers=layers),
              rt.CompressionConfig(num_layers=layers))
    tp = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 64))
    return dict(jcfg=jcfg, tcfg=tcfg, cj=cj, ct=ct, tp=tp, jp=jax_tree(tp),
                ids=ids)


def test_decode_loop_with_penalties_counts_and_logprobs_matches_jax(model):
    steps = 12
    params = dict(repetition_penalty=1.3, presence_penalty=0.2,
                  frequency_penalty=0.1)
    jcfg, tcfg, cj, ct = (model[k] for k in ("jcfg", "tcfg", "cj", "ct"))

    def jax_run(p, ids):
        logits, state, _ = jl.prefill_compressed(p, ids, jcfg, cj,
                                                 max_decode_len=steps + 1)
        tok = jnp.argmax(logits, -1)
        toks, _, counts, lps = jl.decode_loop(
            p, tok, state, steps, jcfg, cj, use_fused=False,
            sampling=js.SamplingParams(**params), return_counts=True,
            return_logprobs=True)
        return tok, toks, counts, lps

    j_tok, j_toks, j_counts, j_lps = jax.jit(jax_run)(
        model["jp"], jnp.asarray(model["ids"]))
    logits, state, _ = tl.prefill_compressed(
        model["tp"], torch.from_numpy(model["ids"]), tcfg, ct,
        max_decode_len=steps + 1)
    tok = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    toks, _, counts, lps = tl.decode_loop(
        model["tp"], tok, state, steps, tcfg, ct,
        sampling=ts.SamplingParams(**params), return_counts=True,
        return_logprobs=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(lps.numpy(), np.asarray(j_lps),
                               atol=ATOL_LOGPROBS)
    # The counts are a bincount of the first token and the emitted ones.
    emitted = torch.cat([tok[:, None], toks], 1)
    for r in range(emitted.shape[0]):
        assert torch.equal(counts[r], torch.bincount(
            emitted[r], minlength=tcfg.vocab_size).to(torch.int32))
    assert bool((lps <= 0).all())


def test_sampled_generate_runs_and_top_k_1_is_greedy(model):
    tcfg, ct = model["tcfg"], model["ct"]
    ids = torch.from_numpy(model["ids"])
    greedy, _ = tl.generate(model["tp"], ids, tcfg, ct, max_new_tokens=6)
    top1, _ = tl.generate(model["tp"], ids, tcfg, ct, max_new_tokens=6,
                          sampling=ts.SamplingParams(temperature=0.8,
                                                     top_k=1))
    assert torch.equal(greedy, top1)
    sampled = [tl.generate(model["tp"], ids, tcfg, ct, max_new_tokens=6,
                           temperature=1.0,
                           generator=torch.Generator().manual_seed(5))[0]
               for _ in range(2)]
    assert torch.equal(sampled[0], sampled[1])
    assert sampled[0].shape == (2, 6)
    _, state, _ = tl.prefill_compressed(model["tp"], ids, tcfg, ct,
                                        max_decode_len=4)
    with pytest.raises(ValueError):
        tl.decode_loop(model["tp"], ids[:, 0], state, 2, tcfg, ct,
                       temperature=0.5)
