"""The port's hyperparameter_tuning CLI against the repository's JAX script
(`experiments/hyperparameter_tuning.py`, loaded by path), on the CPU.

Held: `sample_point` / `normalize_point` sequences and `point_to_config`
exactly; the port's own Gaussian process (numpy and scipy) against
scikit-learn's `GaussianProcessRegressor(kernel=Matern(nu=2.5),
normalize_y=True, alpha=1e-4)`, the model the JAX script fits: posterior
mean and std within 1e-6 and the same expected-improvement argmax over
256 candidates; each method's trajectory (the points visited, in order,
and the best) under one deterministic stub objective, the JAX Bayesian
arm on scikit-learn's GP; and one real objective on a 2-layer float32
`tiny_test_model(vocab_size=258)` whose weights, made by the port's
`init_params`, feed both packages: quality exactly, savings within 1e-6
(the score's speed term is host wall time, so scores are not compared).
"""

import dataclasses
import importlib.util
import os
import random
import sys

import numpy as np
import pytest
from sklearn.gaussian_process import GaussianProcessRegressor
from sklearn.gaussian_process.kernels import Matern

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.utils import data as jdata
from realtime_kv_cache_compression_tpu.utils import tokenizer as jtok
from realtime_kv_cache_compression_tpu_torch.experiments import (
    hyperparameter_tuning as ttu)
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.utils import data as tdata
from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
    ByteTokenizer)

from torch_parity import jax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_GP = 1e-6
TOL_STATS = 1e-6


@pytest.fixture(scope="module")
def jtu():
    """The JAX script, loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_hyperparameter_tuning",
        os.path.join(ROOT, "experiments", "hyperparameter_tuning.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sample_and_normalize_sequences_match_jax(jtu):
    assert ttu.SPACE == jtu.SPACE and ttu.BITS_CHOICES == jtu.BITS_CHOICES
    j_rng, t_rng = random.Random(11), random.Random(11)
    for _ in range(40):
        assert ttu.sample_point(t_rng) == jtu.sample_point(j_rng)
    raw = random.Random(5)
    for _ in range(20):  # unnormalized points, every field off its rule
        pt = {k: raw.uniform(lo - 0.2, hi + 0.2)
              for k, (lo, hi) in ttu.SPACE.items()}
        assert ttu.normalize_point(dict(pt)) == jtu.normalize_point(dict(pt))


def test_point_to_config_matches_jax(jtu):
    rng = random.Random(3)
    for _ in range(10):
        pt = ttu.sample_point(rng)
        got = ttu.point_to_config(pt, num_layers=4)
        want = jtu.point_to_config(pt, num_layers=4)
        assert isinstance(got, rt.CompressionConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_gp_posterior_matches_sklearn(jtu):
    rng = np.random.default_rng(0)
    dims = len(ttu.SPACE)
    for n in (4, 6, 9):
        x = rng.random((n, dims))
        y = 0.3 + 0.2 * np.sin(3 * x[:, 0]) + 0.05 * rng.random(n)
        cands = rng.random((256, dims))
        gp = ttu.GaussianProcess(alpha=1e-4).fit(x, y)
        mu, sigma = gp.predict(cands)
        ref = GaussianProcessRegressor(kernel=Matern(nu=2.5),
                                       normalize_y=True,
                                       alpha=1e-4).fit(x, y)
        mu_r, sigma_r = ref.predict(cands, return_std=True)
        assert abs(gp.length_scale - ref.kernel_.length_scale) <= 1e-6 * (
            ref.kernel_.length_scale)
        np.testing.assert_allclose(mu, mu_r, atol=TOL_GP, rtol=0)
        np.testing.assert_allclose(sigma, sigma_r, atol=TOL_GP, rtol=0)
        best = float(y.max())
        z = (mu_r - best) / np.maximum(sigma_r, 1e-9)
        ei_ref = (mu_r - best) * jtu._ncdf(z) + sigma_r * jtu._npdf(z)
        assert int(np.argmax(ttu.expected_improvement(gp, cands, best))) \
            == int(np.argmax(ei_ref))


def _stubbed(tuner_cls):
    """The Tuner with a deterministic objective of the point alone (no
    model): the methods' trajectories depend on the scores only."""
    class Stub(tuner_cls):
        def objective(self, pt):
            score = (0.6 * pt["alpha"] + 0.3 * pt["theta_h"]
                     - (pt["early_layer_ratio"] - 0.7) ** 2
                     + 0.01 * pt["high_precision_bits"]
                     - 0.2 * pt["later_layer_ratio"] * pt["gamma"])
            self.history.append({"point": dict(pt), "score": score})
            return score

    return Stub(None, None, None, [], 1, 256, 4, {}, seed=7)


@pytest.mark.parametrize("method", ["grid_search", "random_search",
                                    "bayesian_optimization",
                                    "evolutionary_search"])
def test_tuner_trajectories_match_jax(jtu, method):
    port, ref = _stubbed(ttu.Tuner), _stubbed(jtu.Tuner)
    best = getattr(port, method)(11)
    want = getattr(ref, method)(11)
    assert [h["point"] for h in port.history] == \
        [h["point"] for h in ref.history]
    assert best == want
    assert port.gp_fits == (11 - 4 if method == "bayesian_optimization"
                            else 0)


def test_objective_matches_jax(jtu, monkeypatch):
    monkeypatch.setattr(jdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setattr(tdata, "_HUB_UNAVAILABLE", True)
    monkeypatch.setitem(sys.modules, "rouge_score", None)
    shape = dict(vocab_size=258, num_layers=2)
    tcfg, jcfg = rt.tiny_test_model(**shape), rj.tiny_test_model(**shape)
    params = tl.init_params(0, tcfg, device="cpu")
    args = (["narrativeqa"], 1, 256, 4, {"context_words": 24})
    port = ttu.Tuner(tcfg, params, ByteTokenizer(), *args)
    ref = jtu.Tuner(jcfg, jax_tree(params), jtok.ByteTokenizer(), *args)
    pt = ttu.sample_point(random.Random(3))
    port.objective(dict(pt))
    ref.objective(dict(pt))
    (got,), (want,) = port.history, ref.history
    assert "error" not in got and "error" not in want
    assert got.keys() == want.keys()
    assert got["point"] == want["point"]
    assert got["quality"] == want["quality"]
    assert abs(got["savings"] - want["savings"]) <= TOL_STATS
    assert port.model_calls == {"prefill": 2, "decode_steps": 2 * 3}
