"""The port's config dataclasses against the JAX package's: the same
field names with the same defaults, so a config written for the JAX
package builds in the port; each field the port took over does what it
says, and a value outside a field's choices raises in ``Solver``."""

import dataclasses

import pytest

import pcg_mpi_solver_tpu.config as jax_config
import pcg_mpi_solver_tpu_torch.config as config
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.solver import Solver

CLASSES = ["SolverConfig", "TimeHistoryConfig", "RunConfig"]


def defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            out[f.name] = type(f.default_factory()).__name__
        else:
            out[f.name] = f.default
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_jax(name):
    ours, theirs = (defaults(getattr(m, name)) for m in (config, jax_config))
    assert ours == theirs
    # the same order too, so positional construction means the same
    assert list(ours) == list(theirs)


@pytest.mark.parametrize("name", CLASSES)
def test_jax_config_with_every_field_set_builds_in_the_port(name):
    """Every field given explicitly, at the JAX package's default (nested
    configs as the port's own objects)."""
    kw = {f.name: getattr(getattr(jax_config, name)(), f.name)
          for f in dataclasses.fields(getattr(jax_config, name))}
    kw = {k: (getattr(config, type(v).__name__)()
              if dataclasses.is_dataclass(v) else v) for k, v in kw.items()}
    assert getattr(config, name)(**kw) == getattr(config, name)()


def changed(section, field, value):
    if section == "run":
        return RunConfig(**{field: value})
    if section == "solver":
        return RunConfig(solver=SolverConfig(**{field: value}))
    return RunConfig(time_history=TimeHistoryConfig(**{field: value}))


def test_setup_shard_rejects_an_unknown_value():
    """RunConfig.setup_shard takes 'auto', 'on' or 'off', as in the JAX
    package (``driver.py:288-291``)."""
    with pytest.raises(ValueError, match="setup_shard"):
        Solver(make_cube_model(4, 3, 3), RunConfig(setup_shard="always"),
               device="cpu")


def _check_trace_resid(s, tmp_path):
    assert s.last_trace.n_recorded == s.iters[0]


def _check_jsonl(name):
    def check(s, tmp_path):
        s.recorder.close()
        assert (tmp_path / name).read_text().strip()
    return check


def _check_profile_spans(s, tmp_path):
    assert s.recorder.profile_spans


def _check_profile_dir(s, tmp_path):
    from pcg_mpi_solver_tpu_torch.obs.profview import find_trace_files

    assert find_trace_files(str(tmp_path / "prof"))


def _check_preflight_off(s, tmp_path):
    assert "preflight.runs" not in s.recorder.counters


def _check_one_process_setup(s, tmp_path):
    # one process: the whole build, whatever the setting
    assert s._setup_range is None and s.pm.part_range in (None, (0, 1))


# each field the slice ported, set away from its default, with what
# shows that it took effect
PORTED = {
    ("solver", "trace_resid"): (64, _check_trace_resid),
    ("run", "telemetry_path"): ("t.jsonl", _check_jsonl("t.jsonl")),
    ("run", "flight_path"): ("f.jsonl", _check_jsonl("f.jsonl")),
    ("run", "telemetry_profile"): (True, _check_profile_spans),
    ("run", "profile_dir"): ("prof", _check_profile_dir),
    ("run", "preflight"): ("off", _check_preflight_off),
    ("run", "comm_probe_iters"): (0, None),
    ("run", "setup_shard"): ("off", _check_one_process_setup),
}


@pytest.mark.parametrize("key", sorted(PORTED),
                         ids=[f"{s}.{f}" for s, f in sorted(PORTED)])
def test_ported_field_takes_effect(tmp_path, key):
    """The fields the port took over build a Solver and do what they
    say (paths under the test's directory)."""
    section, field = key
    value, check = PORTED[key]
    if isinstance(value, str) and value.endswith(("jsonl", "prof")):
        value = str(tmp_path / value)
    cfg = changed(section, field, value)
    cfg.scratch_path = str(tmp_path / "out")
    s = Solver(make_cube_model(4, 3, 3), cfg, device="cpu")
    if field == "comm_probe_iters":
        from pcg_mpi_solver_tpu_torch.solver.driver import ONE_DEVICE_COMM

        # the time data's comm split: none at 0, the one-device split else
        assert s.time_data(0.0, None)["CommProbe"] == {}
        assert s.time_data(0.0, ONE_DEVICE_COMM)["CommProbe"] == \
            ONE_DEVICE_COMM
        assert s.step(1.0).flag == 0
        return
    s.solve()
    assert s.flags == [0]
    check(s, tmp_path)


@pytest.mark.parametrize("section,field,value,match", [
    ("solver", "pallas", "off", "no XLA path"),
    ("solver", "pallas", "interpret", "no XLA path"),
])
def test_other_unported_values_raise(section, field, value, match):
    with pytest.raises(NotImplementedError, match=match):
        Solver(make_cube_model(4, 3, 3), changed(section, field, value),
               device="cpu")


@pytest.mark.parametrize("section,field,value", [
    ("run", "scratch_path", "/elsewhere"), ("run", "model_name", "beam"),
    ("run", "run_id", "7"), ("run", "speed_test", True),
    ("run", "partition_method", "auto"), ("solver", "pallas", "on"),
    ("solver", "donate_carry", False),
    ("time_history", "export_flag", False),
])
def test_fields_without_effect_on_the_solve_are_accepted(section, field,
                                                         value):
    s = Solver(make_cube_model(4, 3, 3), changed(section, field, value),
               device="cpu")
    assert s.step(1.0).flag == 0


def test_unknown_pallas_mode_is_refused_at_construction():
    with pytest.raises(ValueError, match="pallas"):
        SolverConfig(pallas="maybe")
