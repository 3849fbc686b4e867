"""Run-directory store and small serialization helpers.

The JAX package's ``utils/io.py`` with the same layout on disk, file for
file (its tests read a store this module wrote).  Replaces the reference's
file plumbing (src/utils/file_operations.py:
exportz/importz zlib-pickles :32-42, MPI-IO shared-file writes with sidecar
metadata :348-531) with plain .npy/.npz per-array files — no MPI-IO needed
since the host assembles owner-masked arrays directly.  Keeps the reference's
results layout and .mat co-exports so downstream tooling carries over:

    <scratch>/Results_Run<id>[_SpeedTest]/
        ResVecData/   Dof.npy NodeId.npy U_<k>.npy D_<k>.npy ... Time_T.npy
        PlotData/     <model>_PlotData.npz/.mat  <model>_MP<P>_TimeData.npz/.mat
        VTKs/         <model>_<k>.vtu  VTKInfo.txt
"""

from __future__ import annotations

import os
import pickle
import shutil
import zlib
from datetime import datetime
from typing import Dict

import numpy as np


def is_primary() -> bool:
    """True on the one process that performs result-file writes (the
    reference gates shared-file writes on rank 0 / uses MPI-IO offsets,
    file_operations.py:348-396).  The port runs one process (the
    multi-process build is ROADMAP queue 1 item 12), so always True."""
    return True


def exportz(filename: str, data) -> None:
    """zlib-compressed pickle (reference file_operations.py:32-38)."""
    with open(filename, "wb") as f:
        f.write(zlib.compress(pickle.dumps(data, pickle.HIGHEST_PROTOCOL)))


def importz(filename: str):
    with open(filename, "rb") as f:
        return pickle.loads(zlib.decompress(f.read()))


def write_atomic(filename: str, blob) -> None:
    """Atomic-publish discipline for shared directories (cache/,
    concurrent warmup queues): write to a unique per-process tmp, then
    ``os.replace`` — readers only ever see complete files, concurrent
    writers cannot truncate each other's half-write, and a failed write
    leaves no tmp residue.  The ONE copy of this protocol; layer
    serialization on top (``exportz_atomic``, cache/aot.py).

    ``blob``: bytes, or a ``callable(fileobj)`` that STREAMS the payload
    (bench.py's flagship model pickles are multi-hundred-MB — streaming
    avoids materializing the serialized blob on top of the live model)."""
    import threading

    # pid alone is not unique: two threads of one process storing the
    # same cache key would interleave into a single tmp file
    tmp = f"{filename}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            if callable(blob):
                blob(f)
            else:
                f.write(blob)
        os.replace(tmp, filename)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def exportz_atomic(filename: str, data, level: int = -1) -> None:
    """``exportz`` published via :func:`write_atomic`, at zlib ``level``
    (-1: zlib's default; 0 stores without compressing; :func:`importz`
    reads every level)."""
    write_atomic(filename, zlib.compress(
        pickle.dumps(data, pickle.HIGHEST_PROTOCOL), level))


class RunStore:
    """Owns one Results_Run directory.

    Multi-host safe: every write method is a no-op on non-primary processes
    (callers still evaluate their — possibly collective — arguments on all
    processes, so device fetches stay in sync; only the file I/O is gated,
    matching the reference's rank-0 write gating)."""

    def __init__(self, result_path: str, model_name: str = "model",
                 primary: bool = None):
        self.result_path = result_path.rstrip("/")
        self.model_name = model_name
        self.res_vec_path = f"{self.result_path}/ResVecData"
        self.plot_path = f"{self.result_path}/PlotData"
        self.vtk_path = f"{self.result_path}/VTKs"
        # resolved at first write (is_primary)
        self._primary = primary

    @property
    def primary(self) -> bool:
        if self._primary is None:
            self._primary = is_primary()
        return self._primary

    def prepare(self) -> None:
        """Create result dirs; an existing run dir is renamed with a
        timestamp (crude run protection, reference pcg_solver.py:67-70)."""
        if not self.primary:
            return
        if os.path.exists(self.result_path):
            stamp = datetime.now().strftime("%d%m%Y_%H%M%S")
            os.rename(self.result_path, f"{self.result_path}_{stamp}")
        os.makedirs(self.res_vec_path)
        os.makedirs(self.plot_path)

    # -- maps and frames ------------------------------------------------
    def write_map(self, name: str, ids: np.ndarray) -> None:
        if not self.primary:
            return
        np.save(f"{self.res_vec_path}/{name}.npy", ids)

    def read_map(self, name: str) -> np.ndarray:
        return np.load(f"{self.res_vec_path}/{name}.npy")

    def write_frame(self, var: str, k: int, values: np.ndarray) -> None:
        if not self.primary:
            return
        np.save(f"{self.res_vec_path}/{var}_{k}.npy", values)

    def write_frame_shard(self, var: str, k: int, values: np.ndarray,
                          p0: int, p1: int, n_parts: int) -> None:
        """Parallel I/O: EVERY process writes the slice of the frame its
        devices own, named by part range + total (the analogue of the
        reference's MPI-IO writes at computed offsets + sidecar metadata,
        file_operations.py:348-531).  ``read_frame`` reassembles in part
        order.  Not primary-gated by design."""
        os.makedirs(self.res_vec_path, exist_ok=True)
        np.save(f"{self.res_vec_path}/{var}_{k}"
                f".part{p0:05d}-{p1:05d}of{n_parts:05d}.npy", values)

    def read_frame(self, var: str, k: int) -> np.ndarray:
        mono = f"{self.res_vec_path}/{var}_{k}.npy"
        if os.path.exists(mono):
            return np.load(mono)
        import glob
        import re

        shards = glob.glob(f"{self.res_vec_path}/{var}_{k}.part*.npy")
        if not shards:
            raise FileNotFoundError(mono)
        ranged, totals = [], set()
        for s in shards:
            m = re.search(r"\.part(\d+)-(\d+)of(\d+)\.npy$", s)
            if m is None:
                raise ValueError(f"unrecognized frame shard name: {s}")
            ranged.append((int(m.group(1)), int(m.group(2)), s))
            totals.add(int(m.group(3)))
        ranged.sort()
        # The ranges must tile [0, n_parts) exactly — stale shards from an
        # earlier run with a different process layout, or a not-yet-flushed
        # writer, must fail loudly rather than merge into a garbled frame.
        names = [os.path.basename(r[2]) for r in ranged]
        if len(totals) != 1:
            raise ValueError(f"mixed-generation frame shards for {var}_{k}: "
                             f"{names}")
        pos = 0
        for p0, p1, s in ranged:
            if p0 != pos:
                raise ValueError(
                    f"frame shards for {var}_{k} do not tile contiguously "
                    f"(at part {pos}): {names}")
            pos = p1
        if pos != totals.pop():
            raise ValueError(
                f"incomplete frame shards for {var}_{k} (cover {pos} parts): "
                f"{names}")
        return np.concatenate([np.load(s) for _, _, s in ranged])

    def n_frames(self, var: str) -> int:
        import glob
        import re

        ks = set()
        for f in glob.glob(f"{self.res_vec_path}/{var}_*.npy"):
            m = re.match(
                rf"{re.escape(var)}_(\d+)(\.part\d+-\d+of\d+)?\.npy$",
                os.path.basename(f))
            if m:
                ks.add(int(m.group(1)))
        return len(ks)

    def write_time_list(self, times) -> None:
        if not self.primary:
            return
        np.save(f"{self.res_vec_path}/Time_T.npy", np.asarray(times))

    def read_time_list(self) -> np.ndarray:
        return np.load(f"{self.res_vec_path}/Time_T.npy")

    # -- history / timing ----------------------------------------------
    def write_plot_data(self, plot_t, plot_u, plot_dofs) -> None:
        """Probe-dof displacement history: .npz + .mat + rendered PNG
        (reference exportHistoryPlotData + TestPlot PNG,
        pcg_solver.py:817-838, 899-940)."""
        if not self.primary:
            return
        data = {"Plot_T": np.asarray(plot_t), "Plot_U": np.asarray(plot_u),
                "Plot_Dof": np.asarray(plot_dofs) + 1}
        np.savez_compressed(f"{self.plot_path}/{self.model_name}_PlotData",
                            PlotData=np.array(data, dtype=object))
        _savemat(f"{self.plot_path}/{self.model_name}_PlotData.mat", data)
        self._plot_png(data)

    def _plot_png(self, data) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:                        # matplotlib is optional
            return
        fig, ax = plt.subplots(figsize=(7, 4.5))
        t, u = data["Plot_T"], np.atleast_2d(data["Plot_U"])
        for i, dof in enumerate(np.atleast_1d(data["Plot_Dof"])):
            ax.plot(t, u[i], label=f"dof {int(dof)}")
        ax.set_xlabel("time")
        ax.set_ylabel("displacement")
        ax.legend(loc="best", fontsize=8)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(f"{self.plot_path}/{self.model_name}_PlotData.png", dpi=110)
        plt.close(fig)

    def write_time_data(self, n_parts: int, time_data: Dict) -> None:
        """Solve metadata: per-step Flag/RelRes/Iter + timing buckets
        (reference exportTimeData, pcg_solver.py:943-961)."""
        if not self.primary:
            return
        name = f"{self.plot_path}/{self.model_name}_MP{n_parts}_TimeData"
        np.savez_compressed(name, TimeData=np.array(time_data, dtype=object))
        _savemat(name + ".mat", time_data)

    def read_time_data(self, n_parts: int) -> Dict:
        name = f"{self.plot_path}/{self.model_name}_MP{n_parts}_TimeData.npz"
        return np.load(name, allow_pickle=True)["TimeData"].item()


def _savemat(path: str, data: Dict) -> None:
    import scipy.io

    scipy.io.savemat(path, {k: (v if isinstance(v, dict) else np.asarray(v))
                            for k, v in data.items()})
