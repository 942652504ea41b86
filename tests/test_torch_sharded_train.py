"""Tensor- and data-parallel training (`models/train.py` over a sharded
tree) against the JAX package's one-device trainer (CPU, float32, gloo
ranks).

Two 2-layer `tiny_test_model`s, one per mesh, the port's `init_params`
weights feeding both packages (`torch_parity.jax_tree`), B=4 rows of 24
token ids from a seeded numpy draw: on a (1, 2) mesh a MoE model (4
experts, top 2: the experts split over `model`, the router's gradient
summed over it), on a (2, 2) mesh a dense model with one kv head (each
model rank uses it for its own query heads: a gradient summed over
`model`), its rows split over `data`. Ranks run as spawned processes over
a gloo group (`parallel.launch.run_ranks`, the rank side
`tests/torch_ranks.sharded_train_runs`), once per mesh. Held on every
rank, each against the matching slice of JAX's tree (the port's
`shard_params` cuts it):
- `lm_loss` within 1e-5 of JAX's `lm_loss`, unmasked and with the SFT
  mask, and every gradient slice within 1e-5 of `jax.grad`'s;
- two `train_step`s (global-norm clip + AdamW, a schedule whose first
  update runs at lr 0), the clip triggered (masked) and not, against
  JAX's jitted `train_step`: losses within 1e-5, the first step's
  global gradient norm within 1e-5 relative of optax's `global_norm` of
  JAX's gradients, and each rank's parameter slices held to
  `tests/test_torch_train.py`'s rule (TOL_PARAMS but for a
  SENSITIVE_SHARE of the elements, every element within TOL_SENSITIVE).

The token draw (numpy seed 0, as in `tests/test_torch_train.py`) is one
on which the one-rank trainer itself meets that rule at both models.
Adam steps an element whose gradient is near its eps (1e-8) in a
direction that float32 rounding sets, so on other draws the one-rank
port's parameters and JAX's part by more than TOL_SENSITIVE (up to 9.4e-4
at the MoE model on seed 4) with no sharding involved.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.models import train as jtrain
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.parallel import (Mesh,
                                                              run_ranks,
                                                              shard_params)

import torch_ranks
from test_torch_train import (LR, SENSITIVE_SHARE, TOL_GRAD, TOL_LOSS,
                              TOL_PARAMS, TOL_SENSITIVE, _leaves)
from torch_parity import jax_tree

B, S, STEPS, TOTAL = 4, 24, 2, 4
CLIPS = {0.5: True, 1e6: False}  # clip norm -> masked
# mesh (data, model) -> the model's settings
MESHES = {(1, 2): dict(num_experts=4, num_experts_per_tok=2),
          (2, 2): dict(num_kv_heads=1)}


def _cfgs(shape):
    kw = dict(num_layers=2, vocab_size=64, max_position_embeddings=64,
              **MESHES[shape])
    return rt.tiny_test_model(**kw), rj.tiny_test_model(**kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (B, S)).astype(np.int32)
    mask = np.zeros((B, S - 1), bool)
    mask[:, S // 2:S // 2 + 6] = True
    mask[1] = False  # a row with no supervised target
    out = {}
    for shape in MESHES:
        tcfg, jcfg = _cfgs(shape)
        params = tl.init_params(0, tcfg, device="cpu")
        ranks = run_ranks(torch_ranks.sharded_train_runs,
                          shape[0] * shape[1], args=(
                              shape, params, tcfg, torch.from_numpy(ids),
                              torch.from_numpy(mask), STEPS, LR, TOTAL),
                          timeout=240)
        out[shape] = dict(tcfg=tcfg, jcfg=jcfg, params=params,
                          jp=jax_tree(params), ranks=ranks)
    return dict(ids=ids, mask=mask, runs=out)


@functools.lru_cache(maxsize=None)
def _value_and_grad():
    return jax.jit(jax.value_and_grad(jtrain.lm_loss), static_argnums=(2, 3))


def _slice(tree, res, tcfg):
    """The rank's slice of a JAX tree (numpy leaves), as `shard_params`
    cuts the port's."""
    mesh = Mesh(axis_names=("data", "model"), shape=res["shape"],
                coords=res["coords"], groups={"data": None, "model": None})
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)
    return shard_params(tree, mesh, tcfg)


def _jax_grads(setup, shape, masked):
    run = setup["runs"][shape]
    return _value_and_grad()(run["jp"], jnp.asarray(setup["ids"]),
                             run["jcfg"], False,
                             jnp.asarray(setup["mask"]) if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", list(MESHES))
def test_sharded_loss_and_gradients_match_jax(setup, shape, masked):
    run = setup["runs"][shape]
    j_loss, j_grads = _jax_grads(setup, shape, masked)
    for rank, res in enumerate(run["ranks"]):
        loss, grads = res["grads"][masked]
        assert abs(float(loss) - float(j_loss)) <= TOL_LOSS, rank
        want = _slice(j_grads, res, run["tcfg"])
        got_l, want_l = _leaves(grads), _leaves(dict(want))
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        for (path, g), (_, w) in zip(got_l, want_l):
            assert g.shape == w.shape, (rank, path)
            err = float((g - w).abs().max())
            assert err <= TOL_GRAD, (rank, path, err)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("shape", list(MESHES))
def test_sharded_train_steps_match_jax(setup, shape, clip):
    run, masked = setup["runs"][shape], CLIPS[clip]
    j_opt = jtrain.make_optimizer(lr=LR, total_steps=TOTAL, clip_norm=clip)
    j_params, j_state = run["jp"], j_opt.init(run["jp"])
    j_mask = jnp.asarray(setup["mask"]) if masked else None
    step = jax.jit(lambda p, o, x, m: jtrain.train_step(
        p, o, x, run["jcfg"], j_opt, use_flash=False, loss_mask=m))
    j_losses = []
    for _ in range(STEPS):
        j_params, j_state, j_loss = step(j_params, j_state,
                                         jnp.asarray(setup["ids"]), j_mask)
        j_losses.append(float(j_loss))
    j_norm = float(optax.global_norm(_jax_grads(setup, shape, masked)[1]))
    for rank, res in enumerate(run["ranks"]):
        losses, norms, trained = res["train"][clip]
        for i, (loss, want) in enumerate(zip(losses, j_losses)):
            assert abs(float(loss) - want) <= TOL_LOSS, (rank, i)
        assert abs(float(norms[0]) - j_norm) <= 1e-5 * j_norm, rank
        assert (float(norms[0]) >= clip) == (clip < 1.0), float(norms[0])
        n_off = n_all = 0
        for (path, t), (_, j) in zip(
                _leaves(trained), _leaves(dict(_slice(j_params, res,
                                                      run["tcfg"]))),
                strict=True):
            err = (t - j).abs()
            assert float(err.max()) <= TOL_SENSITIVE, (rank, path)
            n_off += int((err > TOL_PARAMS).sum())
            n_all += err.numel()
        assert n_off <= SENSITIVE_SHARE * n_all, (rank, n_off, n_all)
