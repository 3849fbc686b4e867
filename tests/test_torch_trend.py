"""The port's bench-trend sentinel (``obs/trend.py``) against the JAX
package's, on synthetic artifact series built in ``tmp_path``: round
wrappers, lines embedded in a wrapper's tail, raw one-line artifacts,
the zero-value error sentinel and failed rounds.

For lines of one platform and device the port gives JAX's report leg for
leg (verdict, rounds, values, delta) and JAX's exit codes (1 on a
regression, 2 with nothing to compare); its leg labels add the platform
in brackets.  The one deliberate difference: a "tpu" line and a "gpu"
line of the same shape do not pair in the port (they do in JAX).  A
subprocess probe shows that ``obs/trend.py``, ``solver/numpy_ref.py``
and the live baseline's child (``bench.measure_ref_ns``) load no torch.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pcg_mpi_solver_tpu.obs import trend as jtrend
from pcg_mpi_solver_tpu_torch.obs import trend

ROOT = Path(__file__).resolve().parents[1]


def _line(value, platform="gpu", device="NVIDIA H100 80GB HBM3, 700.00 W",
          n_dof=10_328_853, **detail):
    d = {"n_dof": n_dof, "model": "cube", "mode": "mixed",
         "backend": "structured", "pcg_variant": "classic",
         "precond": "jacobi", "nrhs": 1, "platform": platform}
    if device is not None:
        d["device"] = device
    d.update(detail)
    return {"schema": "pcg-tpu-bench/1",
            "metric": "pcg_dof_iterations_per_second", "value": value,
            "unit": "dof*iter/s", "vs_baseline": 1.0, "detail": d}


def _wrapper(parsed, tail_lines=(), rc=0):
    return {"n": 1, "cmd": "python -m pcg_mpi_solver_tpu_torch.bench",
            "rc": rc, "tail": "\n".join(["# log"] + [json.dumps(t) for t
                                                     in tail_lines]),
            "parsed": parsed}


def _write(tmp_path, name, obj):
    p = tmp_path / name
    p.write_text(obj if isinstance(obj, str) else json.dumps(obj))
    return str(p)


def _series(tmp_path, new_value, platform="gpu"):
    """Four rounds of one platform: a wrapper (flagship + an insurance
    twin in its tail + a 128^3 leg), a failed round (its tail's line must
    not count), a raw line, an error sentinel; the fresh artifact is a
    wrapper whose flagship value is ``new_value``."""
    dev = None if platform == "tpu" else "NVIDIA H100 80GB HBM3, 700.00 W"
    kw = dict(platform=platform, device=dev)
    r1 = _write(tmp_path, "BENCH_r01.json", _wrapper(
        _line(8.0e9, **kw),
        tail_lines=[_line(7.0e9, **kw), _line(5.0e9, n_dof=6_440_067,
                                              **kw)]))
    r2 = _write(tmp_path, "BENCH_r02.json", _wrapper(
        None, tail_lines=[_line(1.0e9, **kw)], rc=1))
    r3 = _write(tmp_path, "BENCH_r03.json",
                json.dumps(_line(5.2e9, n_dof=6_440_067, **kw)))
    sentinel = {"metric": "pcg_dof_iterations_per_second", "value": 0.0,
                "unit": "dof*iter/s", "vs_baseline": 0.0,
                "detail": {"error": "boom"}}
    r4 = _write(tmp_path, "BENCH_r04.json", _wrapper(sentinel))
    fresh = _write(tmp_path, "fresh.json", _wrapper(
        _line(new_value, **kw), tail_lines=[_line(new_value, **kw)]))
    return [r1, r2, r3, r4], fresh


@pytest.mark.parametrize("platform", ["gpu", "tpu"])
@pytest.mark.parametrize("new_value,verdict,rc", [
    (6.0e9, "regressed", 1), (9.5e9, "improved", 0), (8.3e9, "flat", 0)])
def test_trend_matches_jax_on_one_platform(tmp_path, capsys, platform,
                                           new_value, verdict, rc):
    paths, fresh = _series(tmp_path, new_value, platform)
    for p in paths + [fresh]:
        assert trend.iter_bench_lines(p) == jtrend.iter_bench_lines(p)
    got = trend.trend_report(paths, fresh=fresh)
    want = jtrend.trend_report(paths, fresh=fresh)
    assert len(got["legs"]) == len(want["legs"]) == 2
    for g, w in zip(got["legs"], want["legs"]):
        assert g.pop("leg").startswith(w.pop("leg") + f" [{platform}")
        assert g == w
    for k in ("regressed", "improved", "flat", "single", "sources",
              "threshold", "schema"):
        assert got[k] == want[k], k
    flagship = [g for g in got["legs"] if g["new_round"] == "fresh.json"]
    assert flagship[0]["verdict"] == verdict
    assert flagship[0]["old_round"] == "BENCH_r01.json"
    assert flagship[0]["old_value"] == 8.0e9      # the round's best line
    assert trend.verdict_line(got) == jtrend.verdict_line(want)
    assert trend.main_cli(paths, fresh=fresh) == \
        jtrend.main_cli(paths, fresh=fresh) == rc
    assert "trend verdict: " in capsys.readouterr().out


def test_trend_nothing_to_compare_exits_2(tmp_path, capsys, monkeypatch):
    failed = _write(tmp_path, "BENCH_r01.json", _wrapper(None, rc=1))
    junk = _write(tmp_path, "BENCH_r02.json", "not json at all")
    for paths in ([failed, junk], [str(tmp_path / "missing.json")]):
        assert trend.main_cli(paths) == jtrend.main_cli(paths) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.chdir(empty)
    assert trend.default_series() == jtrend.default_series() == []
    assert trend.main_cli([]) == jtrend.main_cli([]) == 2
    capsys.readouterr()


def test_trend_keeps_platforms_apart(tmp_path):
    """The same shape measured on a TPU and on the card: JAX's sentinel
    pairs the two (and calls the card's higher number an improvement);
    the port's keeps them as two singletons, and two card lines on
    different power limits stay apart too."""
    tpu = _write(tmp_path, "BENCH_r05.json",
                 _wrapper(_line(4.13e8, platform="tpu", device=None)))
    gpu = _write(tmp_path, "fresh.json", json.dumps(_line(8.1e9)))
    want = jtrend.trend_report([tpu], fresh=gpu)
    assert want["improved"] == 1 and want["single"] == 0
    got = trend.trend_report([tpu], fresh=gpu)
    assert got["single"] == 2
    assert got["regressed"] + got["improved"] + got["flat"] == 0
    assert trend.main_cli([tpu], fresh=gpu) == 0
    low = _write(tmp_path, "low.json", json.dumps(
        _line(7.0e9, device="NVIDIA H100 80GB HBM3, 500.00 W")))
    assert trend.trend_report([gpu], fresh=low)["single"] == 2
    cpu = _write(tmp_path, "cpu.json", json.dumps(
        _line(4.0e7, platform="cpu (CPU FALLBACK — accelerator "
                              "unreachable)", device=None)))
    assert trend.platform_class(json.loads(Path(cpu).read_text())) == "cpu"
    assert trend.trend_report([tpu], fresh=cpu)["single"] == 2


def test_trend_over_committed_rounds_pairs_no_tpu_line(tmp_path):
    """The repository's BENCH_r*.json (read, never written) with a fresh
    card line of the flagship's shape: the port pairs nothing across
    platforms, where JAX's key would pair it with BENCH_r05's TPU line."""
    paths = jtrend.default_series(str(ROOT))
    assert len(paths) >= 5
    fresh = _write(tmp_path, "fresh.json", json.dumps(_line(8.1e9)))
    got = trend.trend_report(paths, fresh=fresh)
    fresh_legs = [g for g in got["legs"] if g["new_round"] == "fresh.json"]
    assert [g["verdict"] for g in fresh_legs] == ["single"]
    want = jtrend.trend_report(paths, fresh=fresh)
    paired = [w for w in want["legs"] if w["new_round"] == "fresh.json"]
    assert paired[0]["old_round"] == "BENCH_r05.json"


PROBE = r"""
import sys
import pcg_mpi_solver_tpu_torch.obs.trend
import pcg_mpi_solver_tpu_torch.solver.numpy_ref
from pcg_mpi_solver_tpu_torch.bench import measure_ref_ns
measure_ref_ns("cube", 192, 1000, 2, 3, 3, 3, 0, 0)
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                             "pcg_mpi_solver_tpu"))))
"""


def test_trend_numpy_ref_and_baseline_child_load_no_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["BENCH_MODEL_CACHE"] = "0"
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    lines = out.stdout.splitlines()
    assert lines[0].startswith("REF_NS ") and "same model" in lines[0]
    assert float(lines[0].split()[1]) > 0
    assert lines[1:] == [""], out.stdout
