"""The solvers.  The package imports neither torch nor numpy by itself:
each export loads its module when first asked for, so the numpy reference
(``solver/numpy_ref.py``, the bench's live baseline) runs in a process
that never loads torch."""

# export -> the module of this package that defines it
_EXPORTS = {
    "select_time_backend": "backends",
    "ManySolveResult": "driver", "Solver": "driver", "StepResult": "driver",
    "normalize_rhs_block": "driver",
    "DynamicsResult": "dynamics", "DynamicsSolver": "dynamics",
    "stable_dt": "dynamics",
    "MassShiftedOps": "newmark", "NewmarkSolver": "newmark",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
