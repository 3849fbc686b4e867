"""The port's strain/stress export against the JAX package's (CPU).

- ``principal_values`` and ``eqv_strain`` on random and degenerate Voigt
  tensors (the exactly-zero initial frame, isotropic, two equal
  eigenvalues) against the JAX package's, float64 and float32: within
  1e-7 x max|v| in float64 and 1e-3 x max|v| in float32 (the trig
  (Cardano) form loses about half the digits where two eigenvalues meet:
  arccos is steep at +-1, and the two packages' arccos differ by an ulp),
  never NaN.
- The nonlocal (NS) operator: the port's host build as a CSR equal to
  the JAX package's, and its device apply (``apply_padded``, a gather,
  multiply and sum) against the CSR product.
- ``elem_strain`` per element: on the slab (the same cell layout in both
  packages) and on the general backend mapped to global element ids (the
  port regroups elements into sign sub-type buckets; the JAX package
  returns one block a pattern type), and on the hybrid backend (its
  transition cells by id, its levels in the JAX package's order),
  within 1e-12 x max|eps|.
- The nodal fields (D, ES, PS1-3, PE1-3) of ``nodal_export_fields`` on the
  structured, general and hybrid backends against the JAX package's on
  the same partition, within 1e-10 x max|field| (sums in another order),
  and against the host float64 oracle (``elem_strain_host``,
  ``elem_stress_host`` + ``nodal_average_host``, global), within the
  same: the oracle chip_smoke.py holds the card to; the hybrid's against
  the general's.  ``elem_stress_host`` equals the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops import nonlocal_stress as jax_nl
from pcg_mpi_solver_tpu.ops import stress as jax_stress
from pcg_mpi_solver_tpu.ops.matvec import Ops as JaxOps
from pcg_mpi_solver_tpu.ops.matvec import device_data as jax_device_data
from pcg_mpi_solver_tpu.parallel.hybrid import HybridOps as JaxHybridOps
from pcg_mpi_solver_tpu.parallel.hybrid import (
    device_data_hybrid as jax_device_data_hybrid,
    partition_hybrid as jax_partition_hybrid)
from pcg_mpi_solver_tpu.parallel.partition import (
    partition_model as jax_partition_model)
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_sdata,
    partition_structured as jax_spartition)
from pcg_mpi_solver_tpu_torch.models import (
    make_cube_model, make_octree_model)
from pcg_mpi_solver_tpu_torch.ops import nonlocal_stress as nl
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops, device_data
from pcg_mpi_solver_tpu_torch.ops.stress import (
    eqv_strain, nodal_export_fields, principal_values)
from pcg_mpi_solver_tpu_torch.parallel.hybrid import (
    HybridOps, device_data_hybrid, partition_hybrid)
from pcg_mpi_solver_tpu_torch.parallel.partition import (
    make_elem_part, partition_model)
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)

FIELDS = ("D", "ES", "PS1", "PS2", "PS3", "PE1", "PE2", "PE3")
VARS = ("D", "ES", "PS", "PE")
CUBE = ((6, 4, 4), dict(E=30e9, heterogeneous=True, seed=5,
                        load_value=1e6))
OCTREE = ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, E=30e9,
                          load="traction", load_value=1e6))


def voigt_cases(dtype, seed=0):
    """(6, N) Voigt tensors: random ones, the zero tensor, isotropic ones
    and ones with two equal eigenvalues (a rotated diag(a, b, b))."""
    rng = np.random.default_rng(seed)
    v = [rng.standard_normal((6, 64)) * 1e6, np.zeros((6, 1)),
         np.array([[3.0, 3.0, 3.0, 0, 0, 0]]).T * 1e-3]
    for a, b in ((2.0, 1.0), (-1.0, 4.0)):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        m = q @ np.diag([a, b, b]) @ q.T
        v.append(np.array([[m[0, 0], m[1, 1], m[2, 2], m[1, 2], m[0, 2],
                            m[0, 1]]]).T)
    return np.concatenate(v, axis=1).astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-7),
                                       (np.float32, 1e-3)])
def test_principal_values_and_eqv_strain_match_jax(dtype, tol):
    v = voigt_cases(dtype)[None]                     # (1, 6, N)
    for fn_t, fn_j in ((principal_values, jax_stress.principal_values),
                       (eqv_strain, jax_stress.eqv_strain)):
        got = fn_t(torch.from_numpy(v)).numpy()
        want = np.asarray(fn_j(jnp.asarray(v)))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.isfinite(got).all()
        scale = np.abs(v).max(axis=1, keepdims=True)
        scale = scale if got.ndim == 3 else scale[:, 0]
        assert (np.abs(got - want) <= tol * np.maximum(scale, 1e-30)).all()
    # the zero frame gives exact zeros; descending order (up to the
    # round-off of the middle value, the trace less the other two); the
    # trace kept
    p = principal_values(torch.from_numpy(v)).numpy()[0]
    assert (p[:, 64] == 0).all()
    slack = tol * np.abs(v[0]).max(axis=0)
    assert (p[0] >= p[1] - slack).all() and (p[1] >= p[2] - slack).all()
    np.testing.assert_allclose(p.sum(axis=0), v[0, :3].sum(axis=0),
                               rtol=0, atol=tol * np.abs(v).max())


@pytest.fixture(scope="module")
def octree_pair():
    args, kw = OCTREE
    return jax_octree(*args, **kw), make_octree_model(*args, **kw)


@pytest.fixture(scope="module")
def cube_pair():
    args, kw = CUBE
    mj, mt = jax_cube(*args, **kw), make_cube_model(*args, **kw)
    # two materials (matrix, inclusions): the NS build's same-material
    # filter matters
    assert len(mt.mat_prop) == 2 and len(np.unique(mt.poly_mat)) == 2
    return mj, mt


def test_nonlocal_weights_equal_jax_and_apply_on_device(cube_pair):
    mj, mt = cube_pair
    wj = jax_nl.build_nonlocal_weights(mj)
    wt = nl.build_nonlocal_weights(mt)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(wt.csr, f), getattr(wj.csr, f))
    assert wt.ref_lc == wj.ref_lc
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(mt.n_elem)
    cols, w = wt.padded_arrays()
    got = nl.apply_padded(torch.from_numpy(cols), torch.from_numpy(w),
                          torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, wt.apply(vals), rtol=0,
                               atol=1e-14 * np.abs(vals).max())
    np.testing.assert_allclose(
        got, np.asarray(jax_nl.apply_padded(jnp.asarray(cols),
                                            jnp.asarray(w),
                                            jnp.asarray(vals))),
        rtol=0, atol=1e-14 * np.abs(vals).max())
    # the host stress and nodal average the NS field is built from
    u = _global_u(mt)
    sig = nl.elem_stress_host(mt, u)
    np.testing.assert_array_equal(sig, jax_nl.elem_stress_host(mj, u))
    vm = nl.von_mises_stress(sig, axis=1)
    np.testing.assert_array_equal(vm, jax_nl.von_mises_stress(sig, axis=1))
    np.testing.assert_array_equal(nl.nodal_average_host(mt, vm),
                                  jax_nl.nodal_average_host(mj, vm))


def _seeded(gid, seed=7, scale=1e-3):
    rng = np.random.default_rng(seed)
    return np.where(gid >= 0, rng.standard_normal(gid.shape) * scale, 0.0)


def _global_u(model, seed=7):
    """A global displacement: smooth plus noise, so every strain
    component is non-zero."""
    rng = np.random.default_rng(seed)
    x = np.asarray(model.node_coords)
    u = np.stack([1e-3 * x[:, 0] * x[:, 1], -2e-3 * x[:, 2],
                  5e-4 * x[:, 0]], axis=1).ravel()
    return u + 1e-4 * rng.standard_normal(u.shape)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= tol, (what, err)


def _local(pm, u_glob):
    return np.where(pm.dof_gid >= 0, u_glob[np.clip(pm.dof_gid, 0, None)],
                    0.0)


def _oracle(model, u):
    """The global host float64 fields the card is held to."""
    sig = torch.from_numpy(nl.elem_stress_host(model, u).T[None])
    eps = torch.from_numpy(nl.elem_strain_host(model, u).T[None])
    pe, ps = principal_values(eps)[0].numpy(), principal_values(sig)[0].numpy()
    out = {"D": nl.nodal_average_host(model, np.zeros(model.n_elem)),
           "ES": nl.nodal_average_host(model, eqv_strain(eps)[0].numpy())}
    for i in range(3):
        out[f"PS{i + 1}"] = nl.nodal_average_host(model, ps[i])
        out[f"PE{i + 1}"] = nl.nodal_average_host(model, pe[i])
    return out


def _to_global(pm, fields, n_node):
    """{var: (P, n_node_loc)} -> {var: (n_node,)} through the owned
    nodes."""
    own = (pm.node_weight > 0) & (pm.node_gid >= 0)
    out = {}
    for k, v in fields.items():
        g = np.zeros(n_node)
        g[pm.node_gid[own]] = np.asarray(v)[own]
        out[k] = g
    return out


def _structured(mj, mt, n_parts):
    spj = jax_spartition(mj, n_parts)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    return ((JaxStructuredOps.from_partition(spj), jax_sdata(spj,
                                                             jnp.float64)),
            (StructuredOps.from_partition(sp),
             device_data_structured(sp, torch.float64, "cpu")), sp)


def _general(mj, mt, n_parts, bucket_values=None):
    ep = make_elem_part(mt, n_parts)
    pj = jax_partition_model(mj, n_parts, elem_part=ep)
    pt = partition_model(mt, n_parts, elem_part=ep)
    return ((JaxOps.from_model(pj), jax_device_data(pj)),
            (Ops.from_model(pt, bucket_values=bucket_values),
             device_data(pt, torch.float64, "cpu",
                         bucket_values=bucket_values)), pt)


def _hybrid(mj, mt, n_parts):
    ep = make_elem_part(mt, n_parts)
    hj = jax_partition_hybrid(mj, n_parts, elem_part=ep)
    ht = partition_hybrid(mt, n_parts, elem_part=ep)
    return ((JaxHybridOps.from_hybrid(hj, combine="gather"),
             jax_device_data_hybrid(hj, jnp.float64)),
            (HybridOps.from_hybrid(ht, combine="gather"),
             device_data_hybrid(ht, torch.float64, "cpu")), ht.pm)


@pytest.mark.parametrize("n_parts", [1, 2])
def test_structured_elem_strain_matches_jax(cube_pair, n_parts):
    mj, mt = cube_pair
    (oj, dj), (ot, dt), sp = _structured(mj, mt, n_parts)
    x = _seeded(sp.dof_gid)
    ej = [np.asarray(e) for e in oj.elem_strain(dj, jnp.asarray(x))]
    et = ot.elem_strain(dt, torch.from_numpy(x))
    assert len(et) == len(ej) == 1 and et[0].shape == ej[0].shape
    _close(et[0], ej[0], 1e-12, "slab strain")
    _close(ot.elem_scale(dt)[0], np.asarray(oj.elem_scale(dj)[0]), 1e-15,
           "slab modulus")


def _general_elem_ids(model, pm):
    """Global element id of every (type block, part, slot) of the JAX
    package's general layout, -1 on padding."""
    out = []
    for tb in pm.type_blocks:
        ids = np.full((pm.n_parts, tb.ck.shape[1]), -1)
        for p in range(pm.n_parts):
            e = np.where((pm.elem_part == p)
                         & (model.elem_type == tb.type_id))[0]
            ids[p, :len(e)] = e
        out.append(ids)
    return out


def _bucket_elem_ids(ops, pm, model, bucket_values=None):
    """Global element id of every (bucket, sub-type, slot) of the port's
    stacked layout, -1 on padding."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import _layout

    lay = _layout(pm, bucket_values)
    per_block = _general_elem_ids(model, pm)
    out = []
    for g, (T, M, *_r) in zip(lay.groups, lay.shapes):
        nmax = M // pm.n_parts
        ids = np.full((T, pm.n_parts, nmax), -1)
        for i, si in enumerate(g):
            st = lay.subs[si]
            for p in range(pm.n_parts):
                ids[i, p, :len(st.sel[p])] = per_block[st.t][p, st.sel[p]]
        out.append(ids.reshape(T, M))
    return out


@pytest.mark.parametrize("bucket_values", [None, 0],
                         ids=["buckets", "one-a-subtype"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_general_elem_strain_matches_jax_by_element(octree_pair, n_parts,
                                                     bucket_values):
    """The octree's reflected pattern instances, at the default bucket
    grouping and at one bucket a sign sub-type."""
    mj, mt = octree_pair
    (oj, dj), (ot, dt), pm = _general(mj, mt, n_parts, bucket_values)
    x = _seeded(pm.dof_gid)
    want = np.zeros((mt.n_elem, 6))
    for ids, e in zip(_general_elem_ids(mt, pm),
                      jax.jit(oj.elem_strain)(dj, jnp.asarray(x))):
        e = np.asarray(e).transpose(0, 2, 1)          # (P, N, 6)
        want[ids[ids >= 0]] = e[ids >= 0]
    got = np.zeros((mt.n_elem, 6))
    seen = np.zeros(mt.n_elem, int)
    for ids, e in zip(_bucket_elem_ids(ot, pm, mt, bucket_values),
                      ot.elem_strain(dt, torch.from_numpy(x))):
        e = e.numpy().transpose(0, 2, 1)              # (T, M, 6)
        got[ids[ids >= 0]] = e[ids >= 0]
        seen[ids[ids >= 0]] += 1
    assert (seen == 1).all()
    _close(got, want, 1e-12, "general strain by element")


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("backend", ["structured", "general", "hybrid"])
def test_nodal_fields_match_jax_and_the_host_oracle(cube_pair, octree_pair,
                                                    backend, n_parts):
    if backend == "structured":
        mj, mt = cube_pair
        (oj, dj), (ot, dt), pm = _structured(mj, mt, n_parts)
    else:
        mj, mt = octree_pair
        (oj, dj), (ot, dt), pm = (_general if backend == "general"
                                  else _hybrid)(mj, mt, n_parts)
    u = _global_u(mt)
    x = _local(pm, u)
    nu = float(mt.mat_prop[0]["Pos"])
    got = nodal_export_fields(ot, dt, torch.from_numpy(x), VARS, nu)
    # jitted: one compile instead of an eager dispatch per op
    want = jax.jit(lambda d, v: jax_stress.nodal_export_fields(
        oj, d, v, VARS, nu))(dj, jnp.asarray(x))
    assert sorted(got) == sorted(want) == sorted(FIELDS)
    valid = pm.node_gid >= 0
    for k in FIELDS:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        _close(got[k].numpy()[valid], np.asarray(want[k])[valid], 1e-10,
               f"{backend} {k} vs JAX")
    glob = _to_global(pm, {k: v.numpy() for k, v in got.items()},
                      mt.n_node)
    oracle = _oracle(mt, u)
    for k in FIELDS:
        _close(glob[k], oracle[k], 1e-10, f"{backend} {k} vs host oracle")
    if backend == "hybrid":
        (_oj, _dj), (og, dg), pg = _general(mj, mt, n_parts)
        gen = _to_global(pg, {k: v.numpy() for k, v in nodal_export_fields(
            og, dg, torch.from_numpy(_local(pg, u)), VARS, nu).items()},
            mt.n_node)
        for k in FIELDS:
            _close(glob[k], gen[k], 1e-12, f"hybrid {k} vs general")


@pytest.mark.parametrize("n_parts", [1, 2])
def test_hybrid_elem_strain_matches_jax(octree_pair, n_parts):
    """The hybrid backend's strains: the transition cells' by global
    element id (the port's buckets against the JAX package's type
    blocks), each level's cells in the JAX package's (P, 6, nb * cells)
    order, within 1e-12 x max|eps|; the moduli likewise."""
    mj, mt = octree_pair
    (oj, dj), (ot, dt), pm = _hybrid(mj, mt, n_parts)
    x = _seeded(pm.dof_gid)
    ej = [np.asarray(e) for e in jax.jit(oj.elem_strain)(dj, jnp.asarray(x))]
    et = [e.numpy() for e in ot.elem_strain(dt, torch.from_numpy(x))]
    nbk, ntb = len(ot.buckets), len(pm.type_blocks)
    levels_j, levels_t = ej[ntb:], et[nbk:]
    assert len(levels_j) == len(levels_t) == len(ot.level_dims) >= 1
    P = pm.n_parts
    for (nb, *_d), a, b in zip(ot.level_dims, levels_t, levels_j):
        a = a.reshape(P, nb, 6, -1).transpose(0, 2, 1, 3).reshape(P, 6, -1)
        _close(a, b, 1e-12, "level strain")
    want = np.zeros((mt.n_elem, 6))
    for ids, e in zip(_general_elem_ids(mt, pm), ej[:ntb]):
        want[ids[ids >= 0]] = e.transpose(0, 2, 1)[ids >= 0]
    got = np.zeros((mt.n_elem, 6))
    for ids, e in zip(_bucket_elem_ids(ot, pm, mt), et[:nbk]):
        got[ids[ids >= 0]] = e.transpose(0, 2, 1)[ids >= 0]
    _close(got, want, 1e-12, "transition strain by element")
    sj = [np.asarray(v) for v in oj.elem_scale(dj)]
    st = [v.numpy() for v in ot.elem_scale(dt)]
    for (nb, *_d), a, b in zip(ot.level_dims, st[nbk:], sj[ntb:]):
        _close(a.reshape(P, -1), b, 1e-15, "level modulus")
