"""Multi-process sharding of the port (``parallel/distributed.py``,
``parallel/mesh.py``): the single-process helpers, then REAL 2- and
4-process ``torch.distributed`` gloo groups on the CPU running the
port's solver, held to the JAX package's single-process 8-part solve
(``tests/test_distributed.py`` runs the JAX package's own multi-process
twins).  Every rank must print the identical result line; the iteration
count may differ from the one-process solve by one, because only the
order of the cross-rank sums differs (ROADMAP's ground rules).

Every spawn is bounded by a timeout of its own (children killed on
expiry) and each child runs one torch thread."""

import inspect
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu_torch.parallel.distributed import (
    HostComm, fetch_addressable, fetch_global, gather_owned_global,
    init_distributed, local_part_range, local_view, make_global_mesh,
    process_count, put_sharded, put_tree)
from pcg_mpi_solver_tpu_torch.parallel.mesh import (
    PARTS_AXIS, Mesh, make_mesh, part_spec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a spawn's own bound, well inside the suite's limit
SPAWN_TIMEOUT_S = 120


# ----------------------------------------------------------------------
# single-process helpers
# ----------------------------------------------------------------------

def test_single_process_no_op_init(monkeypatch):
    for k in ("PCG_TPU_COORDINATOR", "PCG_TPU_NUM_PROCS", "PCG_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 0
    assert process_count() == 1
    mesh = make_global_mesh()
    assert mesh == Mesh() and mesh.world == 1 and mesh.group is None
    assert make_mesh().world == 1 and part_spec() == PARTS_AXIS
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(8)
    # an address without a process count is no group at all
    monkeypatch.setenv("PCG_TPU_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed()


def test_mesh_part_ranges():
    assert [Mesh(world=4, rank=r).part_range(8) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="multiple of the process count"):
        Mesh(world=3, rank=0).part_range(8)
    assert local_part_range(Mesh(world=3, rank=1), 8) is None
    assert local_part_range(None, 8) == (0, 8)


def test_put_and_fetch_are_the_identity_in_one_process():
    x = np.arange(8 * 6, dtype=np.float64).reshape(8, 6)
    if not torch.cuda.is_available():   # no device asked for: the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            put_sharded(x, None)
    t = put_sharded(x, None, device="cpu")
    np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_array_equal(fetch_global(t), x)
    rows, p0, p1 = fetch_addressable(t)
    assert (p0, p1) == (0, 8)
    np.testing.assert_array_equal(rows, x)
    tree = {"a": np.ones((8, 4)), "b": [np.zeros((8, 2)), None],
            "c": np.ones((3, 3))}
    out = put_tree(tree, None, {"a": "parts", "b": ["parts", "parts"],
                                "c": ()}, device="cpu")
    assert out["b"][1] is None and tuple(out["c"].shape) == (3, 3)
    comm = HostComm()
    assert comm.n_procs == 1
    a = np.arange(5)
    assert comm.allreduce(a, "sum") is a or np.array_equal(
        comm.allreduce(a, "sum"), a)
    assert comm.allreduce_groups([([a], "max")])[0][0] is a


@pytest.mark.parametrize("backend", ["structured", "general", "hybrid"])
def test_local_view_cuts_every_part_array(backend):
    """A rank's view of a partition: n_parts its block, every per-part
    array its rows (type blocks, level grids and combine maps included),
    the global sizes and the shared element matrices untouched; the
    global view of a block of rows gathers back through the full
    partition's owner mask."""
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model
    from pcg_mpi_solver_tpu_torch.parallel.hybrid import partition_hybrid
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model
    from pcg_mpi_solver_tpu_torch.parallel.structured import (
        partition_structured)

    if backend == "structured":
        pm = partition_structured(make_cube_model(8, 4, 4), 4)
    elif backend == "general":
        pm = partition_model(make_cube_model(6, 4, 4), 4)
    else:
        pm = partition_hybrid(make_octree_model(2, 2, 2, max_level=2,
                                                n_incl=2, seed=3), 4)
    loc = local_view(pm, 1, 3)
    assert loc.n_parts == 2 and loc.glob_n_dof == pm.glob_n_dof
    np.testing.assert_array_equal(loc.weight, pm.weight[1:3])
    np.testing.assert_array_equal(loc.dof_gid, pm.dof_gid[1:3])
    if backend == "structured":
        np.testing.assert_array_equal(loc.ck, pm.ck[1:3])
        np.testing.assert_array_equal(loc.Ke, pm.Ke)
    else:
        assert loc.n_iface == pm.n_iface
        np.testing.assert_array_equal(loc.iface_slot, pm.iface_slot[1:3])
        for tl, tp in zip(loc.type_blocks, pm.type_blocks):
            np.testing.assert_array_equal(tl.dof, tp.dof[1:3])
            np.testing.assert_array_equal(tl.Ke, tp.Ke)
    if backend == "hybrid":
        for ll, lp in zip(loc.levels, pm.levels):
            np.testing.assert_array_equal(ll.ck, lp.ck[1:3])
        np.testing.assert_array_equal(loc.combine.gidx,
                                      pm.combine.gidx[1:3])
    assert local_view(pm, 0, 4) is pm
    u = np.random.default_rng(0).standard_normal(
        (pm.n_parts, pm.n_loc)) * (pm.dof_gid >= 0)
    g = gather_owned_global(pm, u)
    m = (pm.weight > 0) & (pm.dof_gid >= 0)
    np.testing.assert_array_equal(g[pm.dof_gid[m]], u[m])


# ----------------------------------------------------------------------
# real multi-process groups
# ----------------------------------------------------------------------

def make_mh_test_model(backend):
    """The multi-process test model: the JAX package's
    ``tests/test_distributed.py::make_mh_test_model`` with the port's
    builders (the same arguments build the same model in both)."""
    if backend == "hybrid":
        from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model

        return make_octree_model(2, 2, 2, max_level=2, n_incl=2, seed=3)
    from pcg_mpi_solver_tpu_torch.models import make_cube_model

    if backend == "structured":
        return make_cube_model(8, 4, 4, heterogeneous=True)
    return make_cube_model(6, 4, 4, heterogeneous=True)


# the head of every child: one torch thread, the group from argv
CHILD_HEAD = r"""
import os, sys
import torch
torch.set_num_threads(1)
from pcg_mpi_solver_tpu_torch.parallel.distributed import (
    init_distributed, make_global_mesh)
N_PROCS = int(sys.argv[3])
pid = init_distributed(sys.argv[1], N_PROCS, int(sys.argv[2]))
mesh = make_global_mesh()
"""


def run_ranks(tmp_path, child_source, n_procs, extra_argv=(), env=None,
              timeout=SPAWN_TIMEOUT_S, check=True):
    """Launch ``n_procs`` ranks of ``child_source`` (argv: coordinator,
    rank, n_procs, *extra_argv) with ``make_mh_test_model`` and
    ``CHILD_HEAD`` in front, and return their output lines starting with
    RESULT (and, with ``check``, assert every rank exited 0).  Output
    goes to files, not pipes (a rank blocked on a full pipe would wedge
    the group); children still running at ``timeout`` are killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / f"child_{os.getpid()}_{port}.py"
    script.write_text(inspect.getsource(make_mh_test_model) + CHILD_HEAD
                      + child_source)
    cenv = {k: v for k, v in os.environ.items()
            if not k.startswith("PCG_TPU_")}
    cenv.update(env or {})
    cenv["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep))
    logs = [tempfile.TemporaryFile("w+") for _ in range(n_procs)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(i),
         str(n_procs)] + [str(a) for a in extra_argv],
        stdout=logs[i], stderr=subprocess.STDOUT, text=True, env=cenv,
        cwd=str(tmp_path)) for i in range(n_procs)]
    outs = []
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if check:
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    return [ln for out in outs for ln in out.splitlines()
            if ln.startswith("RESULT")]


_CHILD_SOLVE = r"""
import glob
import numpy as np
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.utils.io import RunStore

# exports and checkpoints on: every rank computes (collective fetches),
# only rank 0 writes whole files, each rank its own frame shard
scratch, BACKEND = sys.argv[4], sys.argv[5]
cfg = RunConfig(scratch_path=scratch, run_id="mh", checkpoint_every=1,
                solver=SolverConfig(tol=1e-8, max_iter=500),
                time_history=TimeHistoryConfig(
                    time_step_delta=[0.0, 0.5, 1.0],
                    export_flag=True, export_frame_rate=1,
                    plot_flag=True, probe_dofs=(3, 10)))
s = Solver(make_mh_test_model(BACKEND), cfg, mesh=mesh, n_parts=8,
           backend=BACKEND, device="cpu")
assert s.backend == BACKEND, s.backend
store = RunStore(cfg.result_path)
res = s.solve(store=store)[-1]
mesh.group.barrier()
n_frames = store.n_frames("U")
n_shards = len(glob.glob(os.path.join(cfg.result_path, "ResVecData",
                                      "U_0.part*.npy")))
n_ckpts = len(glob.glob(os.path.join(cfg.checkpoint_path, "ckpt_*.npz")))
print(f"RESULT {pid} flag={res.flag} iters={res.iters} "
      f"relres={res.relres:.6e}", flush=True)
print(f"FILES {pid} primary={store.primary} frames={n_frames} "
      f"ckpts={n_ckpts}", flush=True)
assert res.flag == 0
assert store.primary == (pid == 0)
assert n_shards == N_PROCS, n_shards
assert n_frames == 3, n_frames
# the joined frame is the collective owner-masked payload
np.testing.assert_array_equal(store.read_frame("U", 2),
                              s.displacement_owned())
if pid == 0:
    assert n_ckpts == 2, n_ckpts
"""

_REF_ITERS = {}


def _jax_reference_iters(backend):
    """The JAX package's single-process 8-part solve of the same model
    (conftest's 8 virtual CPU devices), once per backend."""
    if backend not in _REF_ITERS:
        from pcg_mpi_solver_tpu import RunConfig, SolverConfig
        from pcg_mpi_solver_tpu.parallel import make_mesh as jax_mesh
        from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
        from test_distributed import make_mh_test_model as jax_model

        cfg = RunConfig(solver=SolverConfig(tol=1e-8, max_iter=500))
        s = JaxSolver(jax_model(backend), cfg, mesh=jax_mesh(8), n_parts=8,
                      backend=backend)
        res = s.step(1.0)
        assert res.flag == 0
        _REF_ITERS[backend] = int(res.iters)
    return _REF_ITERS[backend]


@pytest.mark.parametrize("n_procs,backend", [(2, "general"), (4, "general"),
                                             (2, "hybrid"),
                                             (2, "structured")])
def test_multi_process_solve(tmp_path, n_procs, backend):
    results = run_ranks(tmp_path, _CHILD_SOLVE, n_procs,
                        [tmp_path / "scratch", backend])
    assert len(results) == n_procs
    # every rank holds the identical converged state
    tails = {r.split(" ", 2)[2] for r in results}
    assert len(tails) == 1, results
    assert "flag=0" in results[0]
    # and the iterations are the JAX package's one-process 8-part solve's,
    # within the one the cross-rank sum order may move
    iters = int(results[0].split("iters=")[1].split()[0])
    assert abs(_jax_reference_iters(backend) - iters) <= 1


_CHILD_NEWMARK = r"""
import numpy as np
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.solver import NewmarkSolver

cfg = RunConfig(solver=SolverConfig(tol=1e-10, max_iter=1000,
                                    precond="block3"))
nm = NewmarkSolver(make_mh_test_model("general"), cfg, mesh=mesh,
                   n_parts=8, dt=0.2, damping=0.1, device="cpu")
res = nm.run([0.5, 1.0, 1.0])
u = nm.state_global()[0]          # a collective fetch on every rank
print(f"RESULT {pid} flags={[r.flag for r in res]} "
      f"iters={[r.iters for r in res]} cs={float(np.abs(u).sum()):.12e}",
      flush=True)
assert all(r.flag == 0 for r in res)
# explicit dynamics across the ranks: one probe sum over ranks a chunk
from pcg_mpi_solver_tpu_torch.solver import DynamicsSolver, stable_dt

model = make_mh_test_model("general")
dyn = DynamicsSolver(model, RunConfig(), n_parts=8, mesh=mesh,
                     dt=0.5 * stable_dt(model), probe_dofs=(3, 10),
                     device="cpu")
out = dyn.run(40, export_every=20)
np.save(os.path.join(sys.argv[4], f"dyn{pid}.npy"),
        np.concatenate([out.u, out.probe_u.ravel()]))
"""


def test_multi_process_newmark(tmp_path):
    """Implicit Newmark (block3) over 2 ranks: both integrate the same
    trajectory, within the tolerance ``tests/test_distributed.py`` holds
    the JAX package's own 2-process run to (rtol 1e-9) of its 8-part
    single-process trajectory; and explicit dynamics over the same ranks
    against the port's one-process run."""
    results = run_ranks(tmp_path, _CHILD_NEWMARK, 2, [tmp_path])
    assert results[0].split(" ", 2)[2] == results[1].split(" ", 2)[2]
    # the explicit run: both ranks the same state and probe series, the
    # one-process run's to round-off (the probe sums cross ranks)
    from pcg_mpi_solver_tpu_torch import RunConfig as PortConfig
    from pcg_mpi_solver_tpu_torch.solver import DynamicsSolver, stable_dt

    d0, d1 = (np.load(tmp_path / f"dyn{p}.npy") for p in (0, 1))
    np.testing.assert_array_equal(d0, d1)
    model = make_mh_test_model("general")
    one = DynamicsSolver(model, PortConfig(), n_parts=8,
                         dt=0.5 * stable_dt(model), probe_dofs=(3, 10),
                         device="cpu").run(40, export_every=20)
    np.testing.assert_allclose(
        d0, np.concatenate([one.u, one.probe_u.ravel()]), rtol=1e-12,
        atol=1e-12 * np.abs(one.u).max())
    from pcg_mpi_solver_tpu import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu.parallel import make_mesh as jax_mesh
    from pcg_mpi_solver_tpu.solver import NewmarkSolver as JaxNewmark
    from test_distributed import make_mh_test_model as jax_model

    cfg = RunConfig(solver=SolverConfig(tol=1e-10, max_iter=1000,
                                        precond="block3"))
    nm = JaxNewmark(jax_model("general"), cfg, mesh=jax_mesh(8), n_parts=8,
                    dt=0.2, damping=0.1)
    nm.run([0.5, 1.0, 1.0])
    cs_ref = float(np.abs(nm.state_global()[0]).sum())
    cs = float(results[0].split("cs=")[1])
    assert np.isclose(cs, cs_ref, rtol=1e-9), (cs, cs_ref)


_CHILD_COUNTS = r"""
import json
import numpy as np
import torch
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.distributed import HostComm
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.solver.pcg import pcg, pcg_many

g = mesh.group
out = {}
for backend in ("general", "structured"):
    s = Solver(make_mh_test_model(backend), RunConfig(), mesh=mesh,
               n_parts=8, backend=backend, device="cpu")
    ops, data = s.ops, s.data
    x = data["eff"].clone()
    g.reset_counts()
    ops.matvec(data, x)
    out[backend + "/matvec"] = dict(g.counts)
    prec = make_prec(ops, data, "jacobi")
    fext = data["eff"] * data["F"]
    for variant in ("classic", "fused", "pipelined"):
        for R in (1, 3):
            got = []
            for k in (4, 8):
                g.reset_counts()
                if R == 1:
                    res = pcg(ops, data, fext, torch.zeros_like(fext), prec,
                              tol=1e-30, max_iter=k,
                              glob_n_dof_eff=s.pm.glob_n_dof_eff,
                              variant=variant)
                else:
                    blk = ops.block_data(data, R)
                    fb = torch.stack([fext * (j + 1) for j in range(R)])
                    res = pcg_many(ops, blk, fb, torch.zeros_like(fb), prec,
                                   tol=1e-30, max_iter=k,
                                   glob_n_dof_eff=s.pm.glob_n_dof_eff,
                                   variant=variant)
                got.append(dict(g.counts))
            out[f"{backend}/{variant}/R{R}"] = {
                c: (got[1][c] - got[0][c]) / 4 for c in got[0]}
    if backend == "structured":
        # the calc / comm-wait split of RunConfig.comm_probe_iters
        split = s.measure_comm_split(2)
        out["probe"] = sorted(split) + [0.0 <= split["comm_frac"] <= 1.0,
                                        split["full_s_per_iter"] > 0]
# the mg V-cycle across ranks: each rank restricts its own parts, the
# first-coarse vector summed over the group
from pcg_mpi_solver_tpu_torch import SolverConfig

r = Solver(make_mh_test_model("structured"), RunConfig(solver=SolverConfig(
    tol=1e-8, max_iter=500, precond="mg")), mesh=mesh, n_parts=8,
    device="cpu").step(1.0)
out["mg"] = [r.flag, r.iters]
# a profiled solve: one capture a rank under p<rank>/, for fleet-report
Solver(make_mh_test_model("structured"), RunConfig(
    profile_dir=os.path.join(sys.argv[4], "prof")), mesh=mesh, n_parts=8,
    device="cpu").solve()
# the packed host exchange: an out-of-range value raises on every rank
# before any collective; the chunked gather-reduce reduces as the plain
# one does
comm = HostComm()
try:
    comm.allreduce_groups([([np.asarray([2 ** 40])], "max")])
    out["overflow"] = False
except OverflowError:
    out["overflow"] = True
vals = np.arange(11, dtype=np.int64) * (pid + 1)
comm.CHUNK = 4
chunked = comm.allreduce_groups([([vals[:6]], "sum"), ([vals[6:]], "max")])
out["chunked"] = [a.tolist() for (a,), in [(c,) for c in chunked]]
print("RESULT " + json.dumps(out, sort_keys=True), flush=True)
"""


def test_collectives_a_trip_and_a_matvec_hold_jax_table(tmp_path):
    """The collectives of a 2-rank solve, counted on the group (the
    difference between 8 and 4 iterations, over 4): a classic
    trip does the JAX package's three scalar reductions, fused and
    pipelined one (``PCG_SCALAR_PSUMS``); each matvec adds one interface
    reduction (general) or one plane exchange of two messages
    (structured, one message a rank); none of it depends on the block
    width R.  The comm probe measures the group's calc / comm-wait
    split, an mg solve over the ranks (one restriction sum a cycle)
    takes the one-process mg solve's iterations, and the fleet report
    aligns the ranks' profile captures on their gloo rounds."""
    import json

    from pcg_mpi_solver_tpu.ops.matvec import PCG_SCALAR_PSUMS

    results = run_ranks(tmp_path, _CHILD_COUNTS, 2, [tmp_path])
    got = [json.loads(r[len("RESULT "):]) for r in results]
    assert got[0] == got[1]          # the same collectives on both ranks
    assert got[0]["probe"] == ["calc_s_per_iter", "comm_frac",
                               "full_s_per_iter", True, True]
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    one = Solver(make_mh_test_model("structured"), RunConfig(
        solver=SolverConfig(tol=1e-8, max_iter=500, precond="mg")),
        n_parts=8, device="cpu").step(1.0)
    assert got[0]["mg"][0] == one.flag == 0
    assert abs(got[0]["mg"][1] - one.iters) <= 1
    # the fleet report aligns the two captures on their gloo rounds
    from pcg_mpi_solver_tpu_torch.obs.fleet import fleet_report

    rep = fleet_report(str(tmp_path / "prof"))
    assert rep["n_processes"] == 2 and rep["verdict"] == "ok", rep
    assert rep["matched_collectives"] > 0 and rep["skew_frac"] is not None
    assert {"matvec", "reduction"} <= set(rep["phases"]), rep["phases"]
    for rank in got:
        assert rank["general/matvec"]["all_reduce"] == 1
        assert rank["general/matvec"]["halo"] == 0
        assert rank["structured/matvec"]["all_reduce"] == 0
        assert rank["structured/matvec"]["halo"] == 1
        assert rank["structured/matvec"]["halo_msgs"] == 1
        for variant, scalar in PCG_SCALAR_PSUMS.items():
            for R in (1, 3):
                gen = rank[f"general/{variant}/R{R}"]
                st = rank[f"structured/{variant}/R{R}"]
                assert gen["all_reduce"] == scalar + 1, (variant, R, gen)
                assert gen["halo"] == 0
                assert st["all_reduce"] == scalar, (variant, R, st)
                assert st["halo"] == 1 and st["halo_msgs"] == 1
        assert rank["overflow"] is True
    # the two ranks' messages: one each way across the one boundary
    assert sum(r["structured/matvec"]["halo_msgs"] for r in got) == 2
    vals = [np.arange(11) * (p + 1) for p in range(2)]
    assert got[0]["chunked"] == [(vals[0][:6] + vals[1][:6]).tolist(),
                                 np.maximum(vals[0][6:],
                                            vals[1][6:]).tolist()]
