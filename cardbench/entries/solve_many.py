"""Entry ``solve_many``: a block of load cases a call through
``Solver.solve_many``, from zero, with homogeneous Dirichlet data."""


def prepare(solver, model) -> None:
    return None


def solve(solver, fb):
    res = solver.solve_many(fb)
    return int(res.trips), [int(f) for f in res.flags], res.x


def answer(solver, handle):
    return solver.displacement_global_many(handle)


def dirichlet(model):
    return None
