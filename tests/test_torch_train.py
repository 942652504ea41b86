"""The port's trainer (`models/train.py`) vs the JAX package's (CPU, tiny).

One 2-layer float32 `tiny_test_model`; the port's `init_params` weights
feed both packages (`torch_parity.jax_tree`) and token ids come from numpy
with a seed. Held:
- `lm_loss` and its gradient on every tensor against
  `jax.value_and_grad(lm_loss)`, with and without the SFT `loss_mask`,
  within 1e-5 (float32 sums in another order), on the plain attention and
  on SDPA (float32 at n_rep 2: K and V expanded to the query heads);
- the warmup + cosine schedule against optax's at every step of a 20-step
  run, within 1e-7 (optax evaluates it in float32, the port in double);
- three optimizer steps (global-norm clip + AdamW, a schedule whose first
  update runs at lr 0) against JAX's jitted `train_step`, with the clip
  triggered and not: losses within 1e-5; parameters within TOL_PARAMS
  (1e-6) but for at most a SENSITIVE_SHARE of their elements, and every
  element within TOL_SENSITIVE, a twentieth of one update (0.05 lr). Adam
  divides each gradient by its own running magnitude, so an element whose
  gradient is at the rounding level of the float32 sums (3.7e-9 against a
  largest 8e-3 in this run: the two frameworks' values differ by a few
  per cent there) takes a step direction set by that rounding; a handful
  of elements out of 86k move by up to 1.2e-4 apart, the rest within
  1e-6.
"""

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
from realtime_kv_cache_compression_tpu_torch.models import train as ttrain

from torch_parity import jax_tree, to_numpy

TOL_LOSS, TOL_GRAD, TOL_LR, TOL_PARAMS = 1e-5, 1e-5, 1e-7, 1e-6
SENSITIVE_SHARE = 1e-3
LR = 3e-3
TOL_SENSITIVE = 0.05 * LR
B, S, STEPS = 3, 24, 3


@pytest.fixture(scope="module")
def setup():
    cfg = dict(num_layers=2, vocab_size=64, max_position_embeddings=64)
    tcfg, jcfg = rt.tiny_test_model(**cfg), rj.tiny_test_model(**cfg)
    params = tl.init_params(0, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.zeros((B, S - 1), bool)
    mask[:, S // 2:S // 2 + 6] = True
    mask[1] = False  # a row with no supervised target
    return tcfg, jcfg, params, ids, mask


def _leaves(tree):
    """(path, value) pairs of a params tree, in a fixed order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", v) for k in sorted(tree)
                for p, v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", v) for i, x in enumerate(tree)
                for p, v in _leaves(x)]
    return [("", tree)]


def _clone(params):
    return {k: ([{n: t.clone() for n, t in layer.items()} for layer in v]
                if k == "layers" else v.clone()) for k, v in params.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_gradients_match_jax(setup, masked):
    tcfg, jcfg, params, ids, mask = setup
    params = _clone(params)
    j_params = jax_tree(params)
    for _, t in _leaves(params):
        t.requires_grad_(True)
    t_mask = torch.from_numpy(mask) if masked else None
    loss = ttrain.lm_loss(params, torch.from_numpy(ids), tcfg,
                          use_flash=False, loss_mask=t_mask)
    loss.backward()
    j_loss, j_grads = jax.jit(jax.value_and_grad(jtrain.lm_loss),
                              static_argnums=(2, 3))(
        j_params, jnp.asarray(ids), jcfg, False,
        jnp.asarray(mask) if masked else None)
    assert abs(float(loss.detach()) - float(j_loss)) <= TOL_LOSS
    t_leaves, j_leaves = _leaves(params), _leaves(j_grads)
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    for (path, t), (_, g) in zip(t_leaves, j_leaves):
        err = np.abs(to_numpy(t.grad) - np.asarray(g)).max()
        assert err <= TOL_GRAD, (path, err)


def test_sdpa_float32_gqa_loss_and_gradients_match_jax(setup):
    """The SDPA route (`use_flash=True`) in float32 at n_rep 2, where K and
    V are expanded to the query heads before SDPA, against JAX's dense
    route: loss and every gradient within the same limits."""
    tcfg, jcfg, params, ids, _ = setup
    assert tcfg.num_heads // tcfg.num_kv_heads == 2
    params = _clone(params)
    j_params = jax_tree(params)
    for _, t in _leaves(params):
        t.requires_grad_(True)
    loss = ttrain.lm_loss(params, torch.from_numpy(ids), tcfg, use_flash=True)
    loss.backward()
    j_loss, j_grads = jax.jit(jax.value_and_grad(jtrain.lm_loss),
                              static_argnums=(2, 3))(
        j_params, jnp.asarray(ids), jcfg, False, None)
    assert abs(float(loss.detach()) - float(j_loss)) <= TOL_LOSS
    for (path, t), (_, g) in zip(_leaves(params), _leaves(j_grads),
                                 strict=True):
        err = np.abs(to_numpy(t.grad) - np.asarray(g)).max()
        assert err <= TOL_GRAD, (path, err)


def test_schedule_matches_optax_at_every_step():
    total, lr = 20, 3e-3
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=max(int(total * 0.05), 1),
        decay_steps=total, end_value=lr * 0.01)
    ours = ttrain.warmup_cosine_decay(lr, total)
    opt = ttrain.make_optimizer(
        {"w": torch.zeros(2)}, lr=lr, total_steps=total)
    for step in range(total + 3):
        assert abs(ours(step) - float(ref(step))) <= TOL_LR, step
        assert opt.lr_at(step) == ours(step)
    assert ours(0) == 0.0  # the first update runs at lr 0
    const = ttrain.make_optimizer({"w": torch.zeros(2)}, lr=lr)
    assert const.lr_at(0) == const.lr_at(7) == lr


@pytest.mark.parametrize("clip_norm,masked", [(0.5, True), (1e6, False)],
                         ids=["clip_on_masked", "clip_off"])
def test_train_steps_match_jax(setup, clip_norm, masked):
    tcfg, jcfg, params, ids, mask = setup
    lr, total = LR, 4
    params = _clone(params)
    j_params = jax_tree(params)
    before = _leaves(_clone(params))
    opt = ttrain.make_optimizer(params, lr=lr, total_steps=total,
                                clip_norm=clip_norm)
    j_opt = jtrain.make_optimizer(lr=lr, total_steps=total,
                                  clip_norm=clip_norm)
    j_state = j_opt.init(j_params)
    j_step = jax.jit(lambda p, o, x, m: jtrain.train_step(
        p, o, x, jcfg, j_opt, use_flash=False, loss_mask=m))
    t_mask = torch.from_numpy(mask) if masked else None
    j_mask = jnp.asarray(mask) if masked else None
    worst = 0.0
    for step in range(STEPS):
        loss = ttrain.train_step(params, opt, torch.from_numpy(ids), tcfg,
                                 use_flash=False, loss_mask=t_mask)
        j_params, j_state, j_loss = j_step(j_params, j_state,
                                           jnp.asarray(ids), j_mask)
        assert abs(float(loss) - float(j_loss)) <= TOL_LOSS, step
        triggered = float(opt.last_grad_norm) >= clip_norm
        assert triggered == (clip_norm < 1.0), float(opt.last_grad_norm)
    assert opt.count == STEPS
    t_leaves, j_leaves = _leaves(params), _leaves(j_params)
    moved, n_off, n_all = 0.0, 0, 0
    for (path, t), (_, j), (_, t0) in zip(t_leaves, j_leaves, before):
        err = np.abs(to_numpy(t.detach()) - np.asarray(j))
        assert err.max() <= TOL_SENSITIVE, (path, err.max())
        n_off += int((err > TOL_PARAMS).sum())
        n_all += err.size
        worst = max(worst, float(err.max()))
        moved = max(moved, float((t.detach() - t0).abs().max()))
    assert n_off <= SENSITIVE_SHARE * n_all, (n_off, n_all, worst)
    assert moved > lr  # the updates were made in place
    opt.release()
    assert not any(t.requires_grad for _, t in _leaves(params))
