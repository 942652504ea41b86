"""The port's pipeline parallelism vs the JAX package (CPU, float32, gloo
ranks).

`tiny_test_model()` (4 layers, 4 / 2 heads, d=16, hidden 64) with weights
from JAX's `init_params` (through `params_from_jax`), ids of shape (4, 64)
from a seeded numpy draw: JAX's own pipeline test shapes. Held:
- `prefill_layers_compressed` over layers 2-3 at layer_offset=2 on a
  seeded hidden state, then `decode_layers_step` on its state, against
  JAX's: kept positions (each tier's, so the tier labels), validity and
  packed codes byte-equal; hidden states and stats within 1e-5, the
  scales and zero points within 1e-5 relative (zero points reach 1e2);
- `PipelineInference` over 2 and 4 ranks (one spawn per world size, the
  rank side `tests/torch_ranks.pipeline_runs`): prefill logits within
  1e-5 of JAX's `prefill_compressed`, the stats of every layer on every
  rank, and 6 greedy tokens equal to JAX's prefill + `decode_step` path
  (JAX `tests/test_pipeline.py:67-80`);
- `pipeline_lm_loss` at (2 stages, 2 microbatches) and (4, 4) within 2e-5
  relative of JAX's `train.lm_loss` (JAX's own bound);
- one `pipeline_train_step` over 4 stages and 2 microbatches against one
  port `train_step` on the whole model with the same optimizer settings:
  every updated tensor within 1e-5, the loss and the clipped global norm
  too;
- the stack / unstack round trip (each rank holds its stage's layers) and
  the ValueError for a stage count that does not divide the layers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import llama as jl
from realtime_kv_cache_compression_tpu.models import train as jtrain
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.models import train as ttrain
from realtime_kv_cache_compression_tpu_torch.parallel import (
    Mesh, PipelineInference, run_ranks, stack_pipeline_params)

import torch_ranks
from torch_parity import numpy_tree, to_torch

B, S, STEPS, LR = 4, 64, 6, 1e-3
TOL = 1e-5
LOSS_MBS = {2: [2], 4: [4]}
TRAIN_MBS = {2: 0, 4: 2}


@pytest.fixture(scope="module")
def setup():
    jcfg = rj.tiny_test_model()
    jp = numpy_tree(jax.jit(lambda k: jl.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    tcfg = rt.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, ids=ids,
                tp=tl.params_from_jax(jp, device="cpu"),
                jccfg=rj.CompressionConfig(num_layers=jcfg.num_layers),
                tccfg=rt.CompressionConfig(num_layers=jcfg.num_layers))


@pytest.fixture(scope="module")
def jax_path(setup):
    """JAX's prefill logits and stats and its STEPS greedy tokens."""
    jcfg, ccfg = setup["jcfg"], setup["jccfg"]
    params = jax.tree_util.tree_map(jnp.asarray, setup["jp"])

    @jax.jit
    def run(p, ids):
        logits, state, stats = jl.prefill_compressed(p, ids, jcfg, ccfg,
                                                     max_decode_len=16)
        tok = jnp.argmax(logits, -1)
        toks = [tok]
        for _ in range(STEPS - 1):
            step_logits, state = jl.decode_step(p, tok, state, jcfg, ccfg)
            tok = jnp.argmax(step_logits, -1)
            toks.append(tok)
        return logits, stats, jnp.stack(toks, axis=1)

    logits, stats, toks = run(params, jnp.asarray(setup["ids"]))
    loss = {mb: float(jax.jit(lambda p, i: jtrain.lm_loss(p, i, jcfg))(
        params, jnp.asarray(setup["ids"]))) for mb in (2, 4)}
    return {"logits": np.asarray(logits), "stats": numpy_tree(stats),
            "tokens": np.asarray(toks), "loss": loss}


@pytest.fixture(scope="module")
def ranks(setup):
    """The rank results per world size, each spawned once."""
    @functools.lru_cache(maxsize=None)
    def spawn(n):
        return run_ranks(torch_ranks.pipeline_runs, n, args=(
            setup["tp"], setup["tcfg"], setup["tccfg"],
            torch.from_numpy(setup["ids"]), STEPS, LOSS_MBS[n],
            TRAIN_MBS[n], LR), timeout=240)
    return spawn


def _pipe_mesh(n):
    """A pipe mesh of coordinates without groups (the refusals issue no
    collective)."""
    return Mesh(axis_names=("pipe",), shape={"pipe": n}, coords={"pipe": 0},
                groups={"pipe": None})


def test_layer_range_functions_match_jax(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jccfg, tccfg = setup["jccfg"], setup["tccfg"]
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, S, jcfg.hidden_size)).astype(np.float32)
    h1 = rng.standard_normal((2, 1, jcfg.hidden_size)).astype(np.float32)
    prompt_len, lo, max_dec = jccfg.prompt_length(S), 2, 8
    jlayers = jax.tree_util.tree_map(jnp.asarray, setup["jp"]["layers"][lo:])

    @jax.jit
    def jrun(layers, h, h1):
        pos = jnp.broadcast_to(jnp.arange(S)[None], (2, S))
        cos, sin = jl.rope_tables(pos, jcfg.head_dim, jcfg.rope_theta,
                                  jcfg.rope_scaling)
        h_out, caches, recents, pools, stats = jl.prefill_layers_compressed(
            layers, lo, h, pos, cos, sin, prompt_len, jcfg, jccfg, max_dec)
        q_pos = jnp.full((2, 1), S, jnp.int32)
        cos1, sin1 = jl.rope_tables(q_pos, jcfg.head_dim, jcfg.rope_theta,
                                    jcfg.rope_scaling)
        h_dec, _, _ = jl.decode_layers_step(layers, h1, caches, recents,
                                            pools, q_pos, cos1, sin1, jcfg,
                                            jccfg)
        return h_out, caches, stats, h_dec

    jh, jcaches, jstats, jdec = jrun(jlayers, jnp.asarray(h), jnp.asarray(h1))

    pos = torch.arange(S)[None].expand(2, S)
    cos, sin = tl.rope_tables(pos, tcfg.head_dim, tcfg.rope_theta,
                              tcfg.rope_scaling)
    th, tcaches, recents, pools, tstats = tl.prefill_layers_compressed(
        setup["tp"]["layers"][lo:], lo, torch.from_numpy(h), pos, cos, sin,
        prompt_len, tcfg, tccfg, max_dec)
    q_pos = torch.full((2, 1), S, dtype=torch.int32)
    cos1, sin1 = tl.rope_tables(q_pos, tcfg.head_dim, tcfg.rope_theta,
                                tcfg.rope_scaling)
    tdec = tl.decode_layers_step(setup["tp"]["layers"][lo:],
                                 torch.from_numpy(h1), tcaches, recents,
                                 pools, q_pos, cos1, sin1, tcfg, tccfg)

    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=TOL)
    assert len(tcaches) == len(jcaches) == 2
    for jc, tc in zip(jcaches, tcaches):
        for jt, tt in zip(jc.tiers, tc.tiers):
            assert jt.chunk == tt.chunk
            for f in ("positions", "valid", "k_stored", "v_stored"):
                assert torch.equal(to_torch(getattr(jt, f)), getattr(tt, f)), f
            for f in ("k_scale", "k_zp", "v_scale", "v_zp"):
                # Zero points reach 1e2, where a float32 ulp is 1e-5.
                np.testing.assert_allclose(getattr(tt, f).numpy(),
                                           np.asarray(getattr(jt, f)),
                                           rtol=TOL, atol=TOL, err_msg=f)
    for js_, ts_ in zip(jstats, tstats):
        for key, jv in js_.items():
            np.testing.assert_allclose(np.asarray(ts_[key], np.float64),
                                       np.asarray(jv, np.float64), atol=TOL,
                                       err_msg=key)


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_inference_matches_jax(setup, jax_path, ranks, n):
    res = ranks(n)
    for r in res:
        np.testing.assert_allclose(r["logits"].numpy(), jax_path["logits"],
                                   atol=TOL)
        np.testing.assert_array_equal(r["tokens"].numpy(),
                                      jax_path["tokens"])
        assert len(r["stats"]) == setup["jcfg"].num_layers
        for ts_, js_ in zip(r["stats"], jax_path["stats"]):
            np.testing.assert_allclose(ts_["kept_tokens"].numpy(),
                                       js_["kept_tokens"])
            np.testing.assert_allclose(ts_["byte_memory_savings"].numpy(),
                                       js_["byte_memory_savings"], atol=TOL)


@pytest.mark.parametrize("n,mb", [(2, 2), (4, 4)])
def test_pipeline_lm_loss_matches_jax(jax_path, ranks, n, mb):
    for r in ranks(n):
        assert float(r["loss"][mb]) == pytest.approx(jax_path["loss"][mb],
                                                     rel=2e-5)


def test_pipeline_train_step_matches_one_rank(setup, ranks):
    tcfg = setup["tcfg"]
    whole = {k: ([{n: t.clone() for n, t in layer.items()} for layer in v]
                 if k == "layers" else v.clone())
             for k, v in setup["tp"].items()}
    opt = ttrain.make_optimizer(whole, lr=LR)
    loss = ttrain.train_step(whole, opt, torch.from_numpy(setup["ids"]),
                             tcfg)
    for r in ranks(4):
        assert float(r["train_loss"]) == pytest.approx(float(loss), rel=TOL)
        assert float(r["grad_norm"]) == pytest.approx(
            float(opt.last_grad_norm), rel=TOL)
        got = r["trained"]
        for key in ("embed", "final_norm", "lm_head"):
            torch.testing.assert_close(got[key], whole[key].detach(),
                                       atol=TOL, rtol=0)
        for gl, wl in zip(got["layers"], whole["layers"], strict=True):
            for name, t in wl.items():
                torch.testing.assert_close(gl[name], t.detach(), atol=TOL,
                                           rtol=0)
    # The clip was active: the step's norm exceeded clip_norm (1.0).
    assert float(opt.last_grad_norm) > 1.0


def test_stack_roundtrip_and_stage_refusal(setup, ranks):
    tp, tcfg = setup["tp"], setup["tcfg"]
    for rank, r in enumerate(ranks(4)):
        assert torch.equal(r["stage_wq"], tp["layers"][rank]["wq"][None])
        back = r["roundtrip"]
        assert len(back["layers"]) == tcfg.num_layers
        for bl, ol in zip(back["layers"], tp["layers"]):
            assert set(bl) == set(ol)
            assert all(torch.equal(bl[k], ol[k]) for k in ol)
        assert all(torch.equal(back[k], tp[k])
                   for k in ("embed", "final_norm", "lm_head"))
    with pytest.raises(ValueError, match="not divisible"):
        stack_pipeline_params(tp, _pipe_mesh(3))
    with pytest.raises(ValueError, match="not divisible"):
        PipelineInference(tp, tcfg, setup["tccfg"], _pipe_mesh(3))
