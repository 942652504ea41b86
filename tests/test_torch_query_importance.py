"""Query-guided importance in the port vs the JAX package (CPU, float32).

`query_attention_mass` against JAX's on the same numpy inputs: uniform and
ragged rows, a window larger than a row's length, and pool widths odd and
even (JAX pools with a stride-1 "SAME" window, which pads asymmetrically
for an even width): within 1e-6 relative, 1e-12 absolute for the zeroed
padding columns (float32 softmax sums in another order).
`importance_scores` for "query" and "both" fed the same masses: within
1e-6 absolute, as tests/test_torch_compression.py holds the prompt source;
the reference's refusal of a query mass on the minmax (chunk-scored) path.
Then whole prefills on a 2-layer tiny model with the JAX weights
(`params_from_jax`): `prefill_compressed` and the chunked prefill (window
query rows buffered in `q_tails`), uniform and ragged, in "query" and
"both": kept positions, validity and tiers identical, packed codes within
the whole-model limit (tests/torch_parity.py), logits within 1e-4; and the
port's chunked prefill against its one-shot prefill, kept positions
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.ops import attention as ja
from realtime_kv_cache_compression_tpu.ops import importance as ji
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops import attention as ta
from realtime_kv_cache_compression_tpu_torch.ops import importance as ti
from torch_parity import assert_caches_match, jax_tree

RTOL_MASS, ATOL_MASS = 1e-6, 1e-12
ATOL_SCORES = 1e-6
ATOL_LOGITS = 1e-4
LAYERS, PROMPT, CHUNK, LENGTHS = 2, 128, 32, (128, 93)

_j_qmass = jax.jit(ja.query_attention_mass, static_argnums=(2, 4))
_j_scores = jax.jit(ji.importance_scores, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("window,lengths,pool", [
    (8, None, 0),           # uniform
    (8, None, 6),           # uniform, even pool
    (8, (40, 24), 5),       # ragged, odd pool
    (16, (10, 40), 4),      # a row shorter than the window, even pool
])
def test_query_attention_mass_matches_jax(window, lengths, pool):
    rng = np.random.default_rng(window + pool)
    b, s, hq, hkv, d = 2, 40, 4, 2, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = _j_qmass(jnp.asarray(q), jnp.asarray(k), window,
                    None if lens is None else jnp.asarray(lens), pool)
    got = ta.query_attention_mass(
        torch.from_numpy(q), torch.from_numpy(k), window,
        lengths=None if lens is None else torch.from_numpy(lens), pool=pool)
    assert got.shape == (b, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_MASS,
                               atol=ATOL_MASS)
    if lens is not None:
        for r, n in enumerate(lens):
            assert bool((got[r, n:] == 0).all())


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("source", ["query", "both"])
def test_query_guided_scores_match_jax(source, ragged):
    rng = np.random.default_rng(7)
    b, s, layer = 2, 96, 1
    pm = rng.random((b, s)).astype(np.float32)
    qm = rng.random((b, s)).astype(np.float32) * 0.1
    cj = rj.CompressionConfig(num_layers=4, importance_source=source)
    ct = rt.CompressionConfig(num_layers=4, importance_source=source)
    plen = cj.prompt_length(s)
    lens = np.asarray([96, 61], np.int32) if ragged else None
    want = _j_scores(
        jnp.asarray(pm), layer, s, plen, cj,
        lengths=None if lens is None else jnp.asarray(lens),
        query_mass=jnp.asarray(qm))
    got = ti.importance_scores(
        torch.from_numpy(pm), layer, s, plen, ct,
        lengths=None if lens is None else torch.from_numpy(lens),
        query_mass=torch.from_numpy(qm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_SCORES)


def test_query_mass_refused_on_the_minmax_path():
    ct = rt.CompressionConfig(num_layers=2, importance_source="query")
    mass = torch.rand(1, 16)
    with pytest.raises(NotImplementedError):
        ti.importance_scores(mass, 0, 16, 4, ct, query_mass=mass,
                             minmax=(mass.amin(-1, keepdim=True),
                                     mass.amax(-1, keepdim=True)))


@pytest.fixture(scope="module")
def model():
    tcfg = rt.tiny_test_model(num_layers=LAYERS)
    tp = tl.init_params(0, tcfg, device="cpu")
    ids = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                            (len(LENGTHS), PROMPT))
    return dict(jcfg=rj.tiny_test_model(num_layers=LAYERS), tcfg=tcfg,
                tp=tp, jp=jax_tree(tp), ids=ids)


def _ccfgs(source):
    kw = dict(num_layers=LAYERS, importance_source=source,
              query_mass_pool=4)
    return rj.CompressionConfig(**kw), rt.CompressionConfig(**kw)


# Each path in each source, one of them ragged: a JAX compile per case.
@pytest.mark.parametrize("path,source,ragged", [
    ("one_shot", "query", False), ("one_shot", "both", True),
    ("chunked", "query", True), ("chunked", "both", False)])
def test_prefill_matches_jax(model, path, source, ragged):
    cj, ct = _ccfgs(source)
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    lens = np.asarray(LENGTHS, np.int32) if ragged else None
    lens_j = None if lens is None else jnp.asarray(lens)
    lens_t = None if lens is None else torch.from_numpy(lens)
    ids = model["ids"]
    if path == "one_shot":
        j_logits, j_state, _ = jax.jit(
            lambda p, i, n: jl.prefill_compressed(
                p, i, jcfg, cj, max_decode_len=8, lengths=n))(
            model["jp"], jnp.asarray(ids), lens_j)
        t_logits, t_state, _ = tl.prefill_compressed(
            model["tp"], torch.from_numpy(ids), tcfg, ct, max_decode_len=8,
            lengths=lens_t)
    else:
        j_logits, j_state, _ = jax.jit(
            lambda p, i, n: jl.prefill_compressed_chunked(
                p, i, jcfg, cj, chunk_size=CHUNK, max_decode_len=8,
                lengths=n, jit_steps=False))(
            model["jp"], jnp.asarray(ids), lens_j)
        t_logits, t_state, _ = tl.prefill_compressed_chunked(
            model["tp"], torch.from_numpy(ids), tcfg, ct, chunk_size=CHUNK,
            max_decode_len=8, lengths=lens_t)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL_LOGITS)
    assert_caches_match(j_state.caches, t_state.caches, ct)


@pytest.mark.parametrize("source", ["query", "both"])
def test_chunked_prefill_matches_one_shot(model, source):
    _, ct = _ccfgs(source)
    ids, lens = torch.from_numpy(model["ids"]), torch.tensor(LENGTHS)
    st = tl._prefill_chunks(model["tp"], ids, model["tcfg"], ct, CHUNK, lens,
                            None)
    assert len(st.q_tails) == LAYERS
    assert st.q_tails[0].shape == (len(LENGTHS), ct.query_window_for(PROMPT),
                                   model["tcfg"].num_heads,
                                   model["tcfg"].head_dim)
    _, chunked, _ = tl.prefill_chunked_finish(model["tp"], st, model["tcfg"],
                                              ct, max_decode_len=8,
                                              lengths=lens)
    _, one_shot, _ = tl.prefill_compressed(model["tp"], ids, model["tcfg"],
                                           ct, max_decode_len=8, lengths=lens)
    for a, b in zip(chunked.caches, one_shot.caches):
        for ta_, tb in zip(a.tiers, b.tiers):
            assert torch.equal(ta_.positions, tb.positions)
            assert torch.equal(ta_.valid, tb.valid)


def test_compressed_prefix_refuses_query_scoring(model):
    _, ct = _ccfgs("query")
    with pytest.raises(ValueError):
        tl.prefill_chunked_compressed_init(2, PROMPT, CHUNK, model["tcfg"],
                                           ct, device="cpu")
    # The prompt source keeps an empty q_tails.
    prompt = dataclasses.replace(ct, importance_source="prompt")
    st = tl.prefill_chunked_init(2, PROMPT, model["tcfg"], prompt,
                                 device="cpu")
    assert st.q_tails == ()
