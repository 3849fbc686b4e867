"""The metric arithmetic on synthetic traces and small meshes, and, on a
card, the per-layer readers of a real traced run."""

import json

import numpy as np
import pytest

from cardbench.harness import mesh_counts
from cardbench.inputs.cube import make_cube_model
from cardbench.inputs.octree import make_octree_model
from cardbench.metrics import _profile, _roofline
from cardbench.registry import Registry

H100 = "NVIDIA H100 80GB HBM3"


def test_cube150_roofline_is_the_known_bound():
    n = 150
    c = _roofline.matvec_counts(3 * (n + 1) ** 3, n ** 3, 24 * 24, 4)
    assert c["bytes"] == 96_133_128
    b = _roofline.bound_s(c, 4, H100)
    assert b["by"] == "bytes"
    assert b["s"] * 1e6 == pytest.approx(28.696, abs=1e-3)
    assert b["ops_s"] * 1e6 == pytest.approx(23.56, abs=1e-2)


def test_roofline_counts_read_scales_once_a_block_and_no_unknown_card():
    one = _roofline.matvec_counts(300, 50, 576, 4)
    four = _roofline.matvec_counts(300, 50, 576, 4, R=4)
    assert four["bytes"] - 4 * 2 * 300 * 4 == one["bytes"] - 2 * 300 * 4
    assert four["ops"] == 4 * one["ops"]
    assert _roofline.bound_s(one, 4, "cpu") is None
    f64 = _roofline.bound_s(_roofline.matvec_counts(300, 50, 576, 8), 8, H100)
    assert f64["ops_s"] == pytest.approx(2 * 576 * 50 / 67e12)


def test_mesh_counts_of_small_meshes():
    cube = make_cube_model(3)
    cfg = {"solver": {"precision_mode": "mixed", "dtype": "float32"}}
    assert mesh_counts(cube, cfg, 1) == {"n_dof": 192, "n_elem": 27,
                                         "ke_entries": 576, "itemsize": 4,
                                         "block": 1}
    oct_ = make_octree_model(2, 2, 2, max_level=2, n_incl=2)
    mc = mesh_counts(oct_, {"solver": {"precision_mode": "direct",
                                       "dtype": "float64"}}, 2)
    assert mc["itemsize"] == 8 and mc["block"] == 2
    assert mc["ke_entries"] == sum(lib["Ke"].size
                                   for lib in oct_.elem_lib.values())
    assert mc["ke_entries"] > 576


def _x(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def synthetic_trace():
    """Host ranges on lane (1, 1); device ops on (0, 7).  The call range
    spans [0, 100); two trips, each a matvec and a reduction launched in
    their ranges; one kernel launched outside every pcg range; one op
    before the call (left out)."""
    ev = [_x("cardbench/case", "user_annotation", 0, 100)]
    corr = 0
    for base in (0, 50):
        ev.append(_x("pcg/matvec", "user_annotation", base + 1, 5))
        ev.append(_x("pcg/reduce", "user_annotation", base + 10, 30))
        for (t, name, dur) in ((base + 2, "v6", 10.0),
                               (base + 11, "dot", 4.0)):
            corr += 1
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", t, 1,
                         correlation=corr))
            ev.append(_x(name, "kernel", t + 3, dur, pid=0, tid=7,
                         correlation=corr))
    corr += 1
    ev.append(_x("cudaLaunchKernel", "cuda_runtime", 45, 1, correlation=corr))
    ev.append(_x("fill", "kernel", 46, 2, pid=0, tid=7, correlation=corr))
    ev.append(_x("cudaMemcpyAsync", "cuda_runtime", 95, 1, correlation=99))
    ev.append(_x("Memcpy DtoH", "gpu_memcpy", 96, 1, pid=0, tid=7,
                 correlation=99))
    ev.append(_x("early", "kernel", -50, 10, pid=0, tid=7))
    return ev


def test_summary_attributes_phases_busy_and_gaps():
    s = _profile.summarize(synthetic_trace(), "cardbench/case")
    assert s["window_us"] == 100
    assert s["phase_us"]["matvec"] == 20.0
    assert s["phase_us"]["reduction"] == 8.0
    assert s["phase_us"]["other"] == 3.0          # fill + the copy
    assert s["kernels"] == 5
    # busy: [5, 18) + [46, 48) + [55, 68) + [96, 97)
    assert s["busy_us"] == pytest.approx(29.0)
    assert s["ranges"]["pcg/matvec"] == 2
    # gaps [0, 5), [48, 55), [97, 100) open outside every pcg range;
    # [18, 46) and [68, 96) inside a reduction (the host waits on a read)
    assert s["gaps_us"] == {"cardbench/case": 15.0, "pcg/reduce": 56.0}
    assert _profile.top(s["by_name_us"], 1) == [["v6", 20.0]]


def test_summary_without_device_ops_or_range_reads_nothing():
    ev = [e for e in synthetic_trace() if e["cat"] not in ("kernel",
                                                           "gpu_memcpy")]
    assert _profile.summarize(ev, "cardbench/case") is None
    assert _profile.summarize(synthetic_trace(), "cardbench/other") is None


def test_device_lane_fallback_when_the_launch_is_missing():
    ev = [_x("pcg/axpy", "gpu_user_annotation", 0, 50, pid=0, tid=7),
          _x("axpy", "kernel", 10, 5, pid=0, tid=7, correlation=5)]
    ops = _profile.device_ops(ev)
    assert ops[0]["label"] == "pcg/axpy"
    assert _profile.phase_us(ops)["axpy"] == 5


def test_merge_intervals():
    assert _profile.merge_intervals([(3, 4), (0, 2), (1, 3), (5, 5)]) == [
        (0, 4)]


def _record(profile=True):
    s = _profile.summarize(synthetic_trace(), "cardbench/case")
    return {"spans": {"partition": [1.5], "warmup": [0.25],
                      "case": [2.0, 2.2]},
            "counters": {"cases": 2, "calls": 2, "trips": 4000},
            "setup_s": 11.0, "peak_bytes": 3 * 2**30,
            "profile": {"trips": 2, "summary": s} if profile else None,
            "mesh": {"n_dof": 3 * 151 ** 3, "n_elem": 150 ** 3,
                     "ke_entries": 576, "itemsize": 4, "block": 1},
            "device_kind": H100}


@pytest.mark.parametrize("name,value", [
    ("case_s", 2.1), ("peak_mem_gib", 3.0), ("setup_s", 11.0),
    ("iters_per_case", 2000.0), ("ms_per_trip", 4.2 / 4000 * 1e3),
    ("reduce_ms_per_trip", 8.0 / 1e3 / 2),
    ("matvec_ms_per_trip", 20.0 / 1e3 / 2),
    ("matvec_roofline_pct", 100 * 28.69645e-6 / 10e-6),
    # busy 29 us over 2 profiled trips against the window's 4.2 s / 4000
    ("idle_pct", 100 * (1 - 14.5e-6 / (4.2 / 4000))),
    ("busy_ms_per_trip", 0.0145), ("kernels_per_trip", 2.5),
    ("partition_s", 1.5), ("warmup_s", 0.25),
])
def test_readers_on_a_synthetic_record(name, value):
    read = Registry().reader(name)
    assert read(_record()) == pytest.approx(value, rel=1e-4)


@pytest.mark.parametrize("name", ["reduce_ms_per_trip", "matvec_ms_per_trip",
                                  "matvec_roofline_pct", "idle_pct",
                                  "busy_ms_per_trip", "kernels_per_trip"])
def test_trace_readers_read_nothing_without_a_profile(name):
    assert Registry().reader(name)(_record(profile=False)) is None


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_every_layer(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from cardbench.harness import run
    from cardbench.tests.bench_copy import bench_copy

    root = bench_copy(tmp_path, nx=24)
    res = run("cube24.step", 5, 2.0, True, root=root)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {e["name"] for e in json.load(
        open(root / "BENCHMARK.json"))["per_layer"]}
    assert 0 < m["matvec_roofline_pct"] <= 100
    assert 0 <= m["idle_pct"] < 100
    assert res["device"]["busy_s"] > 0
    assert np.isfinite(list(m.values())).all()
