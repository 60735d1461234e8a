"""Hyperparameter search engine of the port (numpy only).

The JAX package's ``hpo/search.py``, whose code needs no JAX: the small
surface of optuna that the search driver uses (``create_study`` ->
``Study.optimize`` -> ``best_trial`` / ``trials_dataframe``) with the
same trial API (``suggest_float(log=...)``, ``set_user_attr``) and the
same failure semantics (a trial that raises scores inf). The first
``n_startup_trials=10`` trials are random search, then a Tree-structured
Parzen Estimator per parameter (:class:`TPESampler`). A study seeded as
the JAX package's suggests the same values in a serial run. The one
change: ``trials_dataframe`` returns rows, a list of dicts with optuna's
column names (``reporting.frames.write_csv(path, rows, index=False)``
writes them as pandas would).
"""

from __future__ import annotations

import concurrent.futures
import datetime
import threading
from typing import Callable, Optional

import numpy as np


class TPESampler:
    """Independent-parameter Tree-structured Parzen Estimator.

    Completed trials are split into the best ``gamma`` fraction ("good")
    and the rest ("bad"); per parameter, Gaussian kernel densities are fit
    over each group (in log space for log-scaled parameters) and the
    candidate maximizing l_good(x) / l_bad(x) among ``n_candidates`` draws
    from the good KDE is proposed — the same scheme optuna's default
    sampler uses per parameter.
    """

    def __init__(self, trials, direction: str, gamma: float = 0.25,
                 n_candidates: int = 24):
        finished = [t for t in trials
                    if t.state == "COMPLETE" and t.value is not None
                    and np.isfinite(t.value)]
        finished.sort(key=lambda t: t.value,
                      reverse=(direction == "maximize"))
        n_good = max(1, int(np.ceil(gamma * len(finished))))
        self.good = finished[:n_good]
        self.bad = finished[n_good:]
        self.n_candidates = n_candidates

    def suggest(self, rng, name, low, high, log):
        def collect(group):
            xs = [t.params[name] for t in group if name in t.params]
            return np.log(xs) if (log and xs) else np.asarray(xs, float)

        zs_good = collect(self.good)
        zs_bad = collect(self.bad)
        if zs_good.size == 0 or zs_bad.size == 0:
            return None  # not enough history for this parameter
        lo, hi = (np.log(low), np.log(high)) if log else (low, high)
        span = hi - lo

        def bandwidth(zs):
            spread = np.std(zs) if zs.size > 1 else span / 4
            return max(float(spread) * 0.9 * zs.size ** -0.2, span / 20)

        bw_g, bw_b = bandwidth(zs_good), bandwidth(zs_bad)

        def kde(zs, bw, x):
            d = (x[:, None] - zs[None, :]) / bw
            return np.mean(np.exp(-0.5 * d * d), axis=1) / bw

        centers = zs_good[rng.integers(0, zs_good.size, self.n_candidates)]
        cands = np.clip(centers + rng.normal(0, bw_g, self.n_candidates),
                        lo, hi)
        score = kde(zs_good, bw_g, cands) / (kde(zs_bad, bw_b, cands) + 1e-12)
        z = float(cands[int(np.argmax(score))])
        return float(np.exp(z)) if log else z

    def suggest_categorical(self, rng, name, choices):
        """Smoothed good/bad frequency ratio over the choice set (the
        categorical arm of optuna's TPE: candidates drawn from the
        Laplace-smoothed "good" distribution, ranked by density ratio)."""

        def counts(group):
            c = np.ones(len(choices))  # Laplace prior
            for t in group:
                v = t.params.get(name)
                for i, ch in enumerate(choices):
                    if v == ch:
                        c[i] += 1
                        break
            return c

        cg = counts(self.good)
        cb = counts(self.bad)
        if cg.sum() == len(choices) or cb.sum() == len(choices):
            return None  # no history for this parameter in one group
        p_good = cg / cg.sum()
        p_bad = cb / cb.sum()
        idx = rng.choice(len(choices), self.n_candidates, p=p_good)
        best = int(idx[int(np.argmax((p_good / p_bad)[idx]))])
        return choices[best]


class Trial:
    def __init__(self, number: int, rng: np.random.Generator,
                 sampler: Optional[TPESampler] = None):
        self.number = number
        self._rng = rng
        self._sampler = sampler
        self.params: dict = {}
        self.user_attrs: dict = {}
        self.value: Optional[float] = None
        self.state = "RUNNING"
        self.datetime_start = datetime.datetime.now()
        self.datetime_complete: Optional[datetime.datetime] = None

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        out = None
        if self._sampler is not None:
            out = self._sampler.suggest(self._rng, name, low, high, log)
        if out is None:  # startup trials / no history: random search
            if log:
                out = float(np.exp(
                    self._rng.uniform(np.log(low), np.log(high))
                ))
            else:
                out = float(self._rng.uniform(low, high))
        self.params[name] = out
        return out

    def suggest_int(self, name: str, low: int, high: int) -> int:
        # The continuous TPE over [low, high], rounded — optuna treats
        # ints as discretized floats; plain random would never leave the
        # startup phase for integer parameters.
        out = None
        if self._sampler is not None:
            z = self._sampler.suggest(self._rng, name, float(low),
                                      float(high), log=False)
            if z is not None:
                out = int(np.clip(round(z), low, high))
        if out is None:
            out = int(self._rng.integers(low, high + 1))
        self.params[name] = out
        return out

    def suggest_categorical(self, name: str, choices):
        out = None
        if self._sampler is not None:
            out = self._sampler.suggest_categorical(
                self._rng, name, list(choices)
            )
        if out is None:
            out = choices[int(self._rng.integers(0, len(choices)))]
        self.params[name] = out
        return out

    def set_user_attr(self, key: str, value):
        self.user_attrs[key] = value


class Study:
    def __init__(self, direction: str = "minimize",
                 study_name: str = "study", seed: int = 0,
                 n_startup_trials: int = 10):
        if direction not in ("minimize", "maximize"):
            raise ValueError(f"unknown direction {direction}")
        self.direction = direction
        self.study_name = study_name
        self.trials: list[Trial] = []
        self._seed = seed
        self._n_startup = n_startup_trials
        self._lock = threading.Lock()

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.direction == "minimize" else a > b

    @property
    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.state == "COMPLETE"
                and t.value is not None and np.isfinite(t.value)]
        if not done:
            raise ValueError("no completed trials")
        best = done[0]
        for t in done[1:]:
            if self._better(t.value, best.value):
                best = t
        return best

    def optimize(self, objective: Callable, n_trials: int = 10,
                 n_jobs: int = 1):
        def run_one(number: int):
            rng = np.random.default_rng(self._seed + number)
            with self._lock:
                have_history = any(
                    t.state == "COMPLETE" and t.value is not None
                    and np.isfinite(t.value) for t in self.trials
                )
                sampler = (
                    TPESampler(list(self.trials), self.direction)
                    if number >= self._n_startup and have_history else None
                )
            trial = Trial(number, rng, sampler)
            try:
                value = objective(trial)
                trial.value = float(value)
                trial.state = "COMPLETE"
            except Exception as e:  # trial failure -> inf, like the driver
                print(f"Trial {number} failed: {e}")
                trial.value = float("inf")
                trial.state = "FAIL"
            trial.datetime_complete = datetime.datetime.now()
            with self._lock:
                self.trials.append(trial)

        # Continue numbering across optimize() calls (optuna semantics):
        # restarting at 0 would reuse rng streams and re-propose already
        # evaluated points.
        start = len(self.trials)
        numbers = range(start, start + n_trials)
        if n_jobs == 1:
            for i in numbers:
                run_one(i)
        else:
            with concurrent.futures.ThreadPoolExecutor(n_jobs) as pool:
                list(pool.map(run_one, numbers))

    def trials_dataframe(self):
        """optuna's trials table as rows, one dict per trial in number
        order, with its columns: number, value, datetime_start,
        datetime_complete, duration, params_*, user_attrs_*, state."""
        rows = []
        for t in sorted(self.trials, key=lambda t: t.number):
            row = {
                "number": t.number,
                "value": t.value,
                "datetime_start": t.datetime_start,
                "datetime_complete": t.datetime_complete,
                "duration": (t.datetime_complete - t.datetime_start)
                if t.datetime_complete else None,
            }
            for k, v in t.params.items():
                row[f"params_{k}"] = v
            for k, v in t.user_attrs.items():
                row[f"user_attrs_{k}"] = v
            row["state"] = t.state
            rows.append(row)
        return rows


def create_study(direction: str = "minimize", study_name: str = "study",
                 seed: int = 0) -> Study:
    return Study(direction=direction, study_name=study_name, seed=seed)
