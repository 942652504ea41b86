"""Hyperparameter tuning with four optimizers over the compression space,
on the port.

    python -m realtime_kv_cache_compression_tpu_torch.experiments.hyperparameter_tuning \
        --method compare --trials 8

The counterpart of the repository's `experiments/hyperparameter_tuning.py`
(which drives the JAX package): the same 10-dim search space with alpha /
beta / gamma renormalized to sum to 1, the same scalarization 0.6 quality
+ 0.3 memory savings + 0.1 speed (1 / (wall + 1)), and the same four
methods — grid, random, Bayesian (a Gaussian-process EI loop) and genetic
(tournament selection, single-point crossover, uniform mutation) — plus
the method comparison, with the same artifacts (`{method}_history.json`,
`comparison.json`, `comparison.csv`). One `random.Random(seed)` drives
every method in the JAX script's call order, so both visit the same points
in the same order; the speed term is host wall time, so scores (and which
point ranks best) differ from run to run in either package.

On the port: `--device` (cuda by default) replaces `--platform`; on a
CUDA device each trial runs K1 in every prefill and K2 in every decode
step, on the CPU their plain versions. The Bayesian method's Gaussian
process is the port's own (`GaussianProcess`: numpy and scipy), the model
scikit-learn's `GaussianProcessRegressor(kernel=Matern(nu=2.5),
normalize_y=True, alpha=1e-4)` fits, so it needs no scikit-learn and never
falls back to random search (the JAX script does where scikit-learn is
missing). The CSV is written with the stdlib `csv` module. A failed trial
scores 0 and is recorded with its error, as in the JAX script (the
evaluator's own per-sample and per-task failures count as the trial's);
after the artifacts are written, the run exits nonzero if any trial
failed.
"""

from __future__ import annotations

import argparse
import itertools
import math
import os
import random
import time
from typing import Any, Dict

import numpy as np
import torch
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.optimize import minimize
from scipy.spatial.distance import cdist, pdist, squareform

from .. import CompressionConfig, tiny_test_model
from ..eval.longbench import LongBenchEvaluator, ModelRunner, recorded_errors
from ..models import llama
from ..utils.data import save_csv, save_json
from ..utils.tokenizer import ByteTokenizer

SPACE = {
    "alpha": (0.1, 0.8),
    "beta": (0.1, 0.8),
    "gamma": (0.1, 0.8),
    "theta_h": (0.5, 0.9),
    "theta_m": (0.1, 0.45),
    "early_layer_ratio": (0.5, 0.95),
    "middle_layer_ratio": (0.35, 0.8),
    "later_layer_ratio": (0.2, 0.6),
    "high_precision_bits": (8, 16),     # categorical-ish
    "medium_precision_bits": (4, 8),
}

BITS_CHOICES = {"high_precision_bits": (8, 16),
                "medium_precision_bits": (4, 8)}


def normalize_point(pt):
    """Renormalize alpha/beta/gamma to sum 1, order ratios and thresholds,
    snap bits to allowed values."""
    s = pt["alpha"] + pt["beta"] + pt["gamma"]
    for k in ("alpha", "beta", "gamma"):
        pt[k] = pt[k] / s
    pt["theta_m"] = min(pt["theta_m"], pt["theta_h"] - 0.05)
    e, m, l = (pt["early_layer_ratio"], pt["middle_layer_ratio"],
               pt["later_layer_ratio"])
    e, m, l = sorted((e, m, l), reverse=True)
    pt.update(early_layer_ratio=e, middle_layer_ratio=m, later_layer_ratio=l)
    for k, choices in BITS_CHOICES.items():
        pt[k] = min(choices, key=lambda c: abs(c - pt[k]))
    return pt


def sample_point(rng):
    pt = {k: rng.uniform(lo, hi) for k, (lo, hi) in SPACE.items()}
    return normalize_point(pt)


def point_to_config(pt, num_layers):
    return CompressionConfig(
        num_layers=num_layers,
        alpha=pt["alpha"], beta=pt["beta"], gamma=pt["gamma"],
        theta_h=pt["theta_h"], theta_m=pt["theta_m"],
        early_layer_ratio=pt["early_layer_ratio"],
        middle_layer_ratio=pt["middle_layer_ratio"],
        later_layer_ratio=pt["later_layer_ratio"],
        high_precision_bits=int(pt["high_precision_bits"]),
        medium_precision_bits=int(pt["medium_precision_bits"]),
        low_precision_bits=2,
    )


class GaussianProcess:
    """GP regression with an isotropic Matern nu = 2.5 kernel, scikit-learn's
    `GaussianProcessRegressor(kernel=Matern(nu=2.5), normalize_y=True,
    alpha=alpha)` step for step: targets standardized (a zero std taken as
    1), `alpha` added to the kernel's diagonal, and the length scale fitted
    by maximizing the log marginal likelihood with L-BFGS-B over log(length
    scale), from 1.0, within (1e-5, 1e5), with its analytic gradient."""

    BOUNDS = (1e-5, 1e5)

    def __init__(self, alpha: float = 1e-4):
        self.alpha = alpha

    @staticmethod
    def _kernel(x, y=None, length_scale=1.0, gradient=False):
        """k(x, y) [n, m] (k(x, x) where y is None), and with `gradient` its
        derivative by log(length scale) [n, n, 1]."""
        if y is None:
            dists = pdist(x / length_scale, metric="euclidean")
        else:
            dists = cdist(x / length_scale, y / length_scale,
                          metric="euclidean")
        k = dists * math.sqrt(5)
        k = (1.0 + k + k ** 2 / 3.0) * np.exp(-k)
        if y is None:
            k = squareform(k)
            np.fill_diagonal(k, 1)
        if not gradient:
            return k
        d = squareform(dists ** 2)[:, :, np.newaxis]
        tmp = np.sqrt(5 * d.sum(-1))[..., np.newaxis]
        k_grad = 5.0 / 3.0 * d * (tmp + 1) * np.exp(-tmp)
        return k, k_grad.sum(-1)[:, :, np.newaxis]

    def _neg_log_marginal_likelihood(self, theta):
        """(-log p(y | X, length scale), its gradient) at theta = [log
        length scale]; +inf where the kernel matrix is not positive
        definite."""
        k, k_grad = self._kernel(self.x, length_scale=np.exp(theta[0]),
                                 gradient=True)
        k[np.diag_indices_from(k)] += self.alpha
        try:
            low = cholesky(k, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return np.inf, np.zeros_like(theta)
        y = self.y[:, np.newaxis]
        a = cho_solve((low, True), y, check_finite=False)
        lml = -0.5 * np.einsum("ik,ik->k", y, a)
        lml -= np.log(np.diag(low)).sum()
        lml -= k.shape[0] / 2 * np.log(2 * np.pi)
        inner = np.einsum("ik,jk->ijk", a, a)
        k_inv = cho_solve((low, True), np.eye(k.shape[0]), check_finite=False)
        inner -= k_inv[..., np.newaxis]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner, k_grad)
        return -lml.sum(-1), -grad.sum(-1)

    def fit(self, x, y) -> "GaussianProcess":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.y_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self.y_std = std if std != 0.0 else 1.0
        self.x, self.y = x, (y - self.y_mean) / self.y_std
        res = minimize(self._neg_log_marginal_likelihood, np.array([0.0]),
                       method="L-BFGS-B", jac=True,
                       bounds=np.log([self.BOUNDS]))
        self.length_scale = float(np.exp(res.x[0]))
        k = self._kernel(x, length_scale=self.length_scale)
        k[np.diag_indices_from(k)] += self.alpha
        self.low = cholesky(k, lower=True, check_finite=False)
        self.weights = cho_solve((self.low, True), self.y, check_finite=False)
        return self

    def predict(self, x):
        """Posterior mean and standard deviation at x [n, dims]."""
        k_trans = self._kernel(np.asarray(x, dtype=np.float64), self.x,
                               length_scale=self.length_scale)
        mean = self.y_std * (k_trans @ self.weights) + self.y_mean
        v = solve_triangular(self.low, k_trans.T, lower=True,
                             check_finite=False)
        var = np.ones(len(k_trans)) - np.einsum("ij,ji->i", v.T, v)
        var[var < 0] = 0.0
        return mean, np.sqrt(var * self.y_std ** 2)


class Tuner:
    def __init__(self, mcfg, params, tokenizer, tasks, max_samples,
                 max_length, max_new_tokens, synthetic_kwargs, seed=0):
        self.mcfg = mcfg
        self.params = params
        self.tokenizer = tokenizer
        self.tasks = tasks
        self.max_samples = max_samples
        self.max_length = max_length
        self.max_new_tokens = max_new_tokens
        self.syn = synthetic_kwargs
        self.rng = random.Random(seed)
        self.history = []
        # The runners' schedule over every trial (prefill calls, warm-ups
        # included, and decode steps), and the GP fits of the Bayesian
        # method.
        self.model_calls = {"prefill": 0, "decode_steps": 0}
        self.gp_fits = 0

    def objective(self, pt):
        """0.6·quality + 0.3·savings + 0.1·speed."""
        try:
            ccfg = point_to_config(pt, self.mcfg.num_layers)
            runner = ModelRunner(self.params, self.mcfg, ccfg,
                                 max_new_tokens=self.max_new_tokens)
            ev = LongBenchEvaluator(runner, self.tokenizer,
                                    max_length=self.max_length,
                                    synthetic_kwargs=self.syn)
            t0 = time.time()
            res = ev.evaluate_all_tasks(self.tasks, self.max_samples)
            wall = time.time() - t0
            for k, v in runner.model_calls.items():
                self.model_calls[k] += v
            errors = recorded_errors(res)
            if errors:
                raise RuntimeError(f"the evaluation recorded {len(errors)} "
                                   f"failures, the first {errors[0]}")
            o = res["overall"]
            score = (0.6 * o["overall_quality_score"]
                     + 0.3 * o.get("overall_avg_memory_savings", 0.0)
                     + 0.1 * (1.0 / (wall + 1.0)))
            rec = {"point": dict(pt), "score": score,
                   "quality": o["overall_quality_score"],
                   "savings": o.get("overall_avg_memory_savings", 0.0),
                   "wall_s": wall}
        except Exception as e:  # objective 0 on error; main exits 1
            rec = {"point": dict(pt), "score": 0.0, "error": repr(e)}
        self.history.append(rec)
        return rec["score"]

    # -- methods ------------------------------------------------------------

    def grid_search(self, n_trials):
        axes = {
            "alpha": (0.2, 0.4, 0.6),
            "theta_h": (0.6, 0.8),
            "early_layer_ratio": (0.7, 0.9),
        }
        combos = list(itertools.product(*axes.values()))[:n_trials]
        for combo in combos:
            pt = sample_point(random.Random(0))
            pt.update(dict(zip(axes.keys(), combo)))
            self.objective(normalize_point(pt))
        return self.best()

    def random_search(self, n_trials):
        for _ in range(n_trials):
            self.objective(sample_point(self.rng))
        return self.best()

    def bayesian_optimization(self, n_trials, n_init=4):
        """GP-EI over the continuous dims (bits handled by snapping)."""
        keys = list(SPACE.keys())

        def to_vec(pt):
            return np.array([(pt[k] - SPACE[k][0])
                             / (SPACE[k][1] - SPACE[k][0]) for k in keys])

        def from_vec(v):
            pt = {k: SPACE[k][0] + float(x) * (SPACE[k][1] - SPACE[k][0])
                  for k, x in zip(keys, v)}
            return normalize_point(pt)

        X, y = [], []
        for _ in range(min(n_init, n_trials)):
            pt = sample_point(self.rng)
            X.append(to_vec(pt))
            y.append(self.objective(pt))
        for _ in range(n_trials - len(X)):
            gp = GaussianProcess(alpha=1e-4).fit(np.stack(X), np.array(y))
            self.gp_fits += 1
            cands = np.random.default_rng(self.rng.randrange(1 << 30)) \
                .random((256, len(keys)))
            v = cands[int(np.argmax(expected_improvement(gp, cands,
                                                         max(y))))]
            pt = from_vec(v)
            X.append(to_vec(pt))
            y.append(self.objective(pt))
        return self.best()

    def evolutionary_search(self, n_trials, pop_size=6, tournament=3,
                            mutate_p=0.25):
        pop = [sample_point(self.rng) for _ in range(pop_size)]
        scores = [self.objective(p) for p in pop]
        evals = pop_size
        keys = list(SPACE.keys())
        while evals < n_trials:
            def pick():
                idx = max(self.rng.sample(range(len(pop)), tournament),
                          key=lambda i: scores[i])
                return pop[idx]

            a, b = pick(), pick()
            cut = self.rng.randrange(1, len(keys))
            child = {k: (a if i < cut else b)[k]
                     for i, k in enumerate(keys)}
            for k in keys:
                if self.rng.random() < mutate_p:
                    lo, hi = SPACE[k]
                    child[k] = self.rng.uniform(lo, hi)
            child = normalize_point(child)
            s = self.objective(child)
            evals += 1
            worst = min(range(len(pop)), key=lambda i: scores[i])
            if s > scores[worst]:
                pop[worst], scores[worst] = child, s
        return self.best()

    def best(self):
        ok = [h for h in self.history if "error" not in h]
        return max(ok, key=lambda h: h["score"]) if ok else None


def expected_improvement(gp: GaussianProcess, cands, best_y: float):
    """EI of each candidate over the best score so far (maximization)."""
    mu, sigma = gp.predict(cands)
    z = (mu - best_y) / np.maximum(sigma, 1e-9)
    return (mu - best_y) * _ncdf(z) + sigma * _npdf(z)


def _ncdf(z):
    return 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))


def _npdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="random",
                    choices=["grid", "random", "bayesian", "genetic",
                             "compare"])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a small run)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--tasks", nargs="+", default=["narrativeqa", "qasper"])
    ap.add_argument("--max-samples", type=int, default=5)
    ap.add_argument("--max-length", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--synthetic-context-words", type=int, default=600)
    ap.add_argument("--output-dir",
                    default="experiments/results_torch/tuning")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Runs the methods; returns {"comparison", "history": {method:
    trials}, "model_calls": {method: the runners' schedule}, "gp_fits":
    {method: count}} for in-process callers. Exits nonzero (SystemExit)
    after writing the artifacts if any trial failed."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    mcfg = tiny_test_model(vocab_size=258, num_layers=args.layers)
    params = llama.init_params(0, mcfg, device=device)

    def make_tuner():
        return Tuner(mcfg, params, ByteTokenizer(), args.tasks,
                     args.max_samples, args.max_length, args.max_new_tokens,
                     {"context_words": args.synthetic_context_words},
                     seed=args.seed)

    os.makedirs(args.output_dir, exist_ok=True)
    methods = (["grid", "random", "bayesian", "genetic"]
               if args.method == "compare" else [args.method])
    comparison, history, calls, gp_fits = {}, {}, {}, {}
    for method in methods:
        tuner = make_tuner()
        fn = {"grid": tuner.grid_search, "random": tuner.random_search,
              "bayesian": tuner.bayesian_optimization,
              "genetic": tuner.evolutionary_search}[method]
        t0 = time.time()
        best = fn(args.trials)
        comparison[method] = {"best": best, "trials": len(tuner.history),
                              "wall_s": time.time() - t0}
        save_json(os.path.join(args.output_dir, f"{method}_history.json"),
                  tuner.history)
        history[method] = tuner.history
        calls[method] = tuner.model_calls
        gp_fits[method] = tuner.gp_fits
        print(f"[{method}] best score="
              f"{best['score'] if best else float('nan'):.4f} "
              f"({len(tuner.history)} trials)", flush=True)
    save_json(os.path.join(args.output_dir, "comparison.json"), comparison)
    save_csv(os.path.join(args.output_dir, "comparison.csv"),
             [{"method": m, "best_score": v["best"]["score"] if v["best"]
               else None, "trials": v["trials"], "wall_s": v["wall_s"]}
              for m, v in comparison.items()])
    failed = [f"{m}: {h['error']}" for m, hs in history.items() for h in hs
              if "error" in h]
    if failed:
        raise SystemExit(f"hyperparameter_tuning: {len(failed)} trials "
                         f"failed (artifacts in {args.output_dir}): "
                         f"{failed}")
    return {"comparison": comparison, "history": history,
            "model_calls": calls, "gp_fits": gp_fits}


if __name__ == "__main__":
    main()
