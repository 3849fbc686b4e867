"""Offline result post-processing: crack-tip tracking and probe time
histories.

Re-designs the reference's dynamics/damage-era offline tools
(file_operations.py:542-787):

- ``calcCrackTipVelocity_TensileBranching`` / ``_Shear`` /
  ``calcCrackTipCoord_CrkArrest`` (:542-726): per frame, rebuild the global
  damage field, select nodes with D >= threshold inside a geometric window,
  take the extremal node along a tracking axis; double-pass moving-average
  smoothing; cumulative crack length; 3-point least-squares slope as the tip
  velocity.
- ``getTimeHistoryData`` (:728-787): locate nodes at given coordinates and
  sample U / nodal-field frames over all time steps, saved as a .mat.

Here they are generic (no hardcoded geometry windows) functions over a
RunStore + ModelData.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.utils.io import RunStore


def global_nodal_frame(store: RunStore, model: ModelData, var: str, k: int,
                       node_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Rebuild a global (n_node,) nodal field from an owner-masked frame
    (reference: A[ResNodeId] = InpData, file_operations.py:569-571)."""
    if node_map is None:
        node_map = store.read_map("NodeId")
    data = store.read_frame(var, k)
    a = np.zeros(model.n_node, dtype=data.dtype)
    a[node_map] = data
    return a


def global_dof_frame(store: RunStore, model: ModelData, k: int,
                     dof_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Rebuild the global (n_dof,) displacement from a 'U' frame."""
    if dof_map is None:
        dof_map = store.read_map("Dof")
    data = store.read_frame("U", k)
    a = np.zeros(model.n_dof, dtype=data.dtype)
    a[dof_map] = data
    return a


def smooth_moving_average(x: np.ndarray, half_window: int = 25,
                          passes: int = 2) -> np.ndarray:
    """Reference smoothing (file_operations.py:581-590): centered moving
    average of width 2*half_window+1 applied ``passes`` times; entries within
    half_window of either end are zeroed (exact reference semantics)."""
    out = np.asarray(x, dtype=float)
    n = len(out)
    for _ in range(passes):
        sm = np.zeros_like(out)
        for q in range(half_window, n - half_window):
            sm[q] = np.mean(out[q - half_window:q + half_window + 1], axis=0)
        out = sm
    return out


def crack_tip_history(
    store: RunStore,
    model: ModelData,
    threshold: float = 0.9,
    window: Optional[np.ndarray] = None,
    track_axis: int = 0,
    damage_var: str = "D",
    n_frames: Optional[int] = None,
) -> np.ndarray:
    """Per-frame crack-tip coordinates (n_frames, 3).

    Frame loop of the reference trackers (file_operations.py:565-576): nodes
    with damage >= ``threshold`` and ``window`` True (a boolean node mask
    replacing the hardcoded ``Nodes[:,1] < 0.02``-style selections), tip =
    the one maximal along ``track_axis``.  Frames with no damaged node keep
    (0, 0, 0), like the reference's zero-initialized array."""
    node_map = store.read_map("NodeId")
    if n_frames is None:
        n_frames = store.n_frames(damage_var)
    if window is None:
        window = np.ones(model.n_node, dtype=bool)
    tips = np.zeros((n_frames, 3))
    for k in range(n_frames):
        D = global_nodal_frame(store, model, damage_var, k, node_map)
        sel = (D >= threshold) & window
        if np.any(sel):
            coords = model.node_coords[sel]
            tips[k] = coords[np.argmax(coords[:, track_axis])]
    return tips


def crack_length_and_velocity(times: np.ndarray, tips: np.ndarray):
    """Cumulative crack length + tip velocity (file_operations.py:595-605):
    length increments are Euclidean tip displacements; velocity at q is the
    slope of a 3-point linear fit of length vs time."""
    n = len(times)
    crk_len = np.zeros(n)
    for q in range(1, n):
        crk_len[q] = crk_len[q - 1] + np.linalg.norm(tips[q] - tips[q - 1])
    vel = np.zeros(n)
    for q in range(1, n - 1):
        vel[q] = np.polyfit(times[q - 1:q + 2], crk_len[q - 1:q + 2], 1)[0]
    return crk_len, vel


def calc_crack_tip_velocity(
    store: RunStore,
    model: ModelData,
    threshold: float = 0.9,
    window: Optional[np.ndarray] = None,
    track_axis: int = 0,
    smooth_half_window: int = 25,
    drop_last: int = 10,
) -> Dict:
    """Full reference pipeline (calcCrackTipVelocity_*, :542-677): track ->
    double smooth -> length -> velocity; saves ``CrackTipVelData.npy`` beside
    the run's ResVecData like the reference (:608)."""
    times = store.read_time_list()
    n_frames = max(len(times) - drop_last, 0)
    tips = crack_tip_history(store, model, threshold, window, track_axis,
                             n_frames=n_frames)
    tips = smooth_moving_average(tips, smooth_half_window, passes=2)
    crk_len, vel = crack_length_and_velocity(times[:n_frames], tips)
    out = {"CTVel": vel, "DmgNodeCoord": tips, "CrkLen": crk_len,
           "Time_T": times[:n_frames]}
    payload = np.empty(4, dtype=object)
    payload[:] = [vel, tips, crk_len, times[:n_frames]]
    np.save(f"{store.result_path}/CrackTipVelData", payload, allow_pickle=True)
    return out


def find_nodes_at(model: ModelData, ref_coords: np.ndarray,
                  tol: float = 1e-12) -> np.ndarray:
    """Node ids at exact coordinates (reference getTimeHistoryData
    coordinate lookup, file_operations.py:755-765); raises if any is
    missing, like the reference."""
    ids = []
    for c in np.atleast_2d(ref_coords):
        hit = np.where(np.all(np.abs(model.node_coords - c) < tol, axis=1))[0]
        if len(hit) == 0:
            raise ValueError(f"no node at coordinates {c}")
        ids.append(hit[0])
    return np.asarray(ids)


def get_time_history_data(
    store: RunStore,
    model: ModelData,
    ref_coords: np.ndarray,
    nodal_vars: Sequence[str] = ("PS1",),
    dof_component: int = 0,
    tol: float = 1e-12,
    save_mat: bool = True,
) -> Dict:
    """Sample displacement component + nodal fields at probe coordinates over
    every frame (reference getTimeHistoryData, file_operations.py:728-787);
    optionally saves ``TimeHistoryData.mat`` like the reference (:787)."""
    node_ids = find_nodes_at(model, ref_coords, tol)
    dof_map = store.read_map("Dof")
    node_map = store.read_map("NodeId") if nodal_vars else None
    times = store.read_time_list()
    out: Dict = {"T": times, "U": []}
    for v in nodal_vars:
        out[v] = []
    for k in range(len(times)):
        u = global_dof_frame(store, model, k, dof_map)
        out["U"].append(u[dof_component::3][node_ids])
        for v in nodal_vars:
            a = global_nodal_frame(store, model, v, k, node_map)
            out[v].append(a[node_ids])
    out["U"] = np.asarray(out["U"])
    for v in nodal_vars:
        out[v] = np.asarray(out[v])
    if save_mat:
        import scipy.io

        scipy.io.savemat(f"{store.result_path}/TimeHistoryData.mat", out)
    return out
