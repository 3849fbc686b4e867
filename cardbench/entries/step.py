"""Entry ``step``: one load case a call through ``Solver.step``, from a
zeroed state (``reset_state``).

The port's step solves at a load factor of the load it holds on the card,
``Solver.data["F"]``: the model's F in the partition's local layout, put
there by ``Solver(...)``.  A case's load goes there, in the same layout
(``pm.dof_gid``, as ``solve_many`` places its columns), inside the call's
wall, and the step runs at factor 1 with the configuration's own
prescribed displacements.  ``prepare`` checks that the model's F placed so
is exactly what the program holds, so each case's load is where the step
reads it.
"""

import numpy as np
import torch

BLOCKS = (1,)


def _place(solver, f: np.ndarray) -> torch.Tensor:
    gid = np.asarray(solver.pm.dof_gid)
    old = solver.data["F"]
    if tuple(gid.shape) != tuple(old.shape):
        raise ValueError(f"the partition's dof map {gid.shape} does not "
                         f"match the program's load {tuple(old.shape)}")
    loc = np.asarray(f, np.float64)[np.clip(gid, 0, None)] * (gid >= 0)
    return torch.as_tensor(loc, dtype=old.dtype).to(old.device)


def prepare(solver, model) -> None:
    placed = _place(solver, model.F)
    if not torch.equal(placed, solver.data["F"]):
        raise ValueError("the model's load, placed by the partition's dof "
                         "map, differs from the load the program holds")


def solve(solver, fb: np.ndarray):
    solver.data["F"] = _place(solver, fb[:, 0])
    solver.reset_state()
    r = solver.step(1.0)
    return int(r.iters), [int(r.flag)], None


def answer(solver, handle) -> np.ndarray:
    return solver.displacement_global()[:, None]


def dirichlet(model):
    return model.Ud
