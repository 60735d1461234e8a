"""The comparison that decides ``correct`` has to fail what is wrong, at a
size a CPU test run holds.

- The control: the plain reference itself, its time loop in bfloat16 (the
  precision below the configurations' float32), put in the program's
  place, reads over every cell's limit, while the program reads under it.
- A run driven through the harness (its look for a card skipped) with the
  timed path broken underneath comes out not correct: a forecast whose
  steps return their state unchanged, and a final field altered where it
  is produced. Faults of a batch or of an exchange between cards have
  nothing to break here: one client, one card.
"""

import time

import pytest
import torch

from bench_copy import tiny, tiny_cells, tiny_copy  # noqa: F401
from portbench import harness, limits, registry
from airpollution_tpu_torch.models import crbe

#: 65 points a side and the cells' own 1,000 steps: the control reads
#: 0.69-0.98 here (33^2 and 200 steps: 0.25-0.53).
CONTROL_SIZES = {"points_per_side": 65, "nt": 1001, "traced_requests": 1}


@pytest.fixture(scope="module")
def control_tree(tmp_path_factory):
    dst = tmp_path_factory.mktemp("control")
    bench = tiny_copy(dst, CONTROL_SIZES)
    return dst / "portbench", bench


@pytest.mark.parametrize("cell", tiny_cells())
def test_control_fails_and_program_passes(control_tree, cell):
    base, bench = control_tree
    mix = registry.resolve(bench, f"tiny.{cell}", base)[1]
    limit = mix["limits"]["max_gap_rel"]
    r = limits.readings(f"tiny.{cell}", 2**31 + 17, 1, witness=True,
                        device="cpu", bench=bench, base=base)
    assert r["program_gap"] < limit
    assert r["control_gap"] > limit
    # The program in float64 follows the reference's algorithm: to
    # rounding on the canvas operator, whose interval both estimate from
    # one start vector; on the uniform one within the interval estimate's
    # own uncertainty (the program starts from its family layout).
    assert r["float64_program_gap"] < limit / 100
    if mix["solver"]["fused_operator"] == "canvas":
        assert r["float64_program_gap"] < 1e-12


def _broken_solve(monkeypatch, fault):
    built = crbe.CRBESolver._build_solve_fn

    def build(self, store_solutions, collect_iters):
        solve = built(self, store_solutions, collect_iters)

        def broken(ops, u0):
            sols, iters, bad = solve(ops, u0)
            return fault(sols, u0), iters, bad
        return broken

    monkeypatch.setattr(crbe.CRBESolver, "_build_solve_fn", build)


def _unchanged(sols, u0):
    """Every step returns its state: the forecast ends where it began."""
    return u0[None].clone()


def _altered(limit):
    def alter(sols, u0):
        """The field's largest value moved by four times the limit's share
        of it: the gap then reads 2 limit / (1 + 2 limit)."""
        out = sols.clone()
        i = int(out[-1].abs().argmax())
        out[-1, i] += 4.0 * limit * float(out[-1, i])
        return out
    return alter


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", tiny_cells())
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    base, bench = tiny
    name = f"tiny.{cell}"
    limit = registry.resolve(bench, name, base)[1]["limits"]["max_gap_rel"]
    _broken_solve(monkeypatch,
                  _unchanged if fault == "unchanged" else _altered(limit))
    result = harness.run(name, 2**31 + 23, 0.2, False, device="cpu",
                         t_start=time.perf_counter(), bench=bench, base=base)
    assert result["correct"] is False
    assert result["checks"]["max_gap_rel"]["value"] > limit
    assert torch.isfinite(torch.tensor(result["checks"]["max_gap_rel"]
                                       ["value"]))


def test_one_fewer_iteration_reading(tiny):
    """``limits.readings(fewer=True)`` runs the program with one solver
    iteration a step fewer than the cell's and reads its gap; the cell's
    own mix keeps its count."""
    base, bench = tiny
    name = "tiny.paper-plume.257"
    before = registry.resolve(bench, name, base)[1]["solver"]
    r = limits.readings(name, 2**31 + 29, 1, fewer=True, device="cpu",
                        bench=bench, base=base)
    assert 0.0 <= r["one_fewer_iteration_gap"] < 1.0
    assert registry.resolve(bench, name, base)[1]["solver"] == before


def test_non_finite_answers_are_failed(tiny, monkeypatch):
    """A final field with a NaN, checked once the window has closed, is a
    failed request, and the run is not correct. The NaN comes after the
    warm-up forecast, whose field the port's own guard reads."""
    base, bench = tiny
    calls = []

    def nan(sols, u0):
        calls.append(1)
        out = sols.clone()
        if len(calls) > 1:
            out[-1, 0] = float("nan")
        return out

    _broken_solve(monkeypatch, nan)
    result = harness.run("tiny.paper-plume.257", 2**31 + 31, 0.2, False,
                         device="cpu", t_start=time.perf_counter(),
                         bench=bench, base=base)
    assert result["correct"] is False
    assert result["failed"] == result["checks"]["failed_requests"]["value"]
    assert 1 <= result["failed"] <= harness.SAMPLE + 1
