"""``correct`` comes out false when the timed path is broken underneath, and
for the control (the program's float32 path in place of the configured
float64-refined one); and true for the program as configured.

The harness's look for a card is skipped (``device="cpu"``); the rest of a
run is driven as the benchmark drives it.  The faults are planted in the
port's ``Solver.step``, which the window calls; one reuses the first
case's answer, scaled, for every later case.  The cells have one chip
and one part, so no exchange between chips exists to leave out.
"""

import numpy as np
import pytest

from cardbench.control import CONTROL
from cardbench.harness import run
from cardbench.tests.bench_copy import bench_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("bench"), nx=8, octree=True)


def _unchanged(step):
    """A step that returns its state unchanged, with a converged flag."""
    def fault(self, delta):
        from pcg_mpi_solver_tpu_torch.solver.driver import StepResult

        return StepResult(flag=0, relres=1e-8, iters=100, wall_s=0.01)
    return fault


def _half(step):
    """Half of the answer left out: the second half of the dofs keep
    their start value."""
    def fault(self, delta):
        r = step(self, delta)
        flat = self.un.reshape(-1)
        flat[flat.numel() // 2:] = 0
        return r
    return fault


def _altered(step):
    """The answer altered where it is produced: scaled by 1 + 1e-5."""
    def fault(self, delta):
        r = step(self, delta)
        self.un = self.un * (1 + 1e-5)
        return r
    return fault


def _one_dof(step):
    """One free dof of the answer altered by a hundredth of its size."""
    def fault(self, delta):
        r = step(self, delta)
        flat = self.un.reshape(-1)
        i = int(flat.abs().argmax())
        flat[i] = flat[i] * 1.01
        return r
    return fault


def _rescaled(step):
    """An earlier case's answer reused: from the second case on, the first
    case's answer scaled by the factor that best fits the new load to the
    first one's (least squares), with no solve."""
    def fault(self, delta):
        import torch
        from pcg_mpi_solver_tpu_torch.solver.driver import StepResult

        first = getattr(self, "_first_case", None)
        if first is None:
            r = step(self, delta)
            self._first_case = (self.un.clone(), self.data["F"].clone())
            return r
        u0, f0 = first
        f = self.data["F"]
        self.un = u0 * (torch.sum(f * f0) / torch.sum(f0 * f0))
        return StepResult(flag=0, relres=1e-8, iters=100, wall_s=0.01)
    return fault


@pytest.mark.parametrize("cell", ["cube8.step", "oct3.step"])
def test_sound_runs_are_correct(root, cell):
    res = run(cell, 2**31 + 5, 0.3, False, root=root, device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["relres_max"]["value"] <= 1e-7
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, _one_dof])
@pytest.mark.parametrize("cell", ["cube8.step", "oct3.step"])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    monkeypatch.setattr(Solver, "step", fault(Solver.step))
    res = run(cell, 11, 0.3, False, root=root, device="cpu")
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
    assert res["checks"]["relres_max"]["value"] > 1e-7


@pytest.mark.parametrize("cell", ["cube8.step", "oct3.step"])
def test_a_rescaled_earlier_answer_is_not_correct(root, cell, monkeypatch):
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    monkeypatch.setattr(Solver, "step", _rescaled(Solver.step))
    res = run(cell, 2**31 + 17, 0.3, False, root=root, device="cpu")
    assert not res["correct"]
    assert res["attempted"] >= 2
    assert res["failed"] == res["attempted"] - 1    # all but the first
    assert res["checks"]["relres_max"]["value"] > 1e-3


@pytest.mark.parametrize("cell", ["cube8.step", "oct3.step"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float32_control_is_not_correct(root, cell, seed):
    res = run(cell, seed, 0.3, False, root=root, device="cpu",
              solver_overrides=CONTROL)
    assert not res["correct"]
    assert res["checks"]["relres_max"]["value"] > 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_float32_control_is_not_correct_on_the_card(tmp_path, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    root = bench_copy(tmp_path, nx=48)
    res = run("cube48.step", seed, 2.0, False, root=root,
              solver_overrides=CONTROL)
    assert not res["correct"]
    assert np.isfinite(res["checks"]["relres_max"]["value"])
    assert res["checks"]["relres_max"]["value"] > 1e-7
    sound = run("cube48.step", seed, 2.0, False, root=root)
    assert sound["correct"], sound["checks"]
