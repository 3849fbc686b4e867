"""The port's block-Jacobi (3x3 node block) preconditioner against the JAX
package's on the same seeded numpy inputs (CPU): the structured backend's
``node_block_diag``, ``invert_node_blocks`` (a degenerate block, a zero
diagonal on a free dof, fixed dofs, an ill-conditioned float32 block),
``make_prec("block3")`` and its apply, in float64 to rtol 1e-12, and the
mixed solve's float32 build (blocks assembled from the float32 data,
inverted in float64, cast back), to the float32 rounding of the same
numbers.  The block3 solves are in ``tests/test_torch_mg.py`` beside the
mg ones."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops.precond import (
    fallback_kind as jax_fallback_kind,
    invert_node_blocks as jax_invert, make_prec as jax_make_prec)
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu_torch.ops.precond import (
    fallback_kind, invert_node_blocks, make_prec)
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)

DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module", params=[1, 2], ids=["P1", "P2"])
def both(request):
    """One heterogeneous 6x4x5 cube partitioned by the JAX package into
    ``P`` slabs, carried across; ops and data of both packages in both
    dtypes."""
    spj = jax_partition(jax_cube(6, 4, 5, E=30e9, nu=0.3,
                                 heterogeneous=True, seed=3),
                        request.param)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    out = {}
    for name, (jd, td) in DTYPES.items():
        out[name] = (JaxStructuredOps.from_partition(spj, dot_dtype=jd),
                     jax_data(spj, jd),
                     StructuredOps.from_partition(sp, dot_dtype=td),
                     device_data_structured(sp, td, "cpu"))
    return out


def test_node_block_diag_matches_jax(both):
    jops, jdat, tops, tdat = both["float64"]
    ref = np.asarray(jops.node_block_diag(jdat))
    got = tops.node_block_diag(tdat).numpy()
    assert got.shape == ref.shape == (tops.n_parts, tops.n_node_loc, 3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_make_prec_block3_matches_jax(both, dtype):
    """float32 is the mixed solve's build: ``make_prec(ops32, data32)``
    assembles the blocks in float32 and inverts them in float64."""
    jops, jdat, tops, tdat = both[dtype]
    ref = np.asarray(jax_make_prec(jops, jdat, "block3"))
    got = make_prec(tops, tdat, "block3")
    assert got.dtype == DTYPES[dtype][1]
    rtol = 1e-12 if dtype == "float64" else 2e-7
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    # fixed dofs act as the identity (unit diagonal, no coupling)
    fixed = tops._as_node3(tdat["eff"]).numpy() == 0
    diag = np.diagonal(got.numpy(), axis1=-2, axis2=-1)
    assert fixed.any() and (diag[fixed] == 1).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_block3_apply_matches_jax(both, dtype):
    jops, jdat, tops, tdat = both[dtype]
    jd, td = DTYPES[dtype]
    r = np.random.default_rng(7).normal(size=(tops.n_parts, tops.n_loc)) \
        * np.asarray(jdat["eff"])
    ref = np.asarray(jops.apply_prec(jax_make_prec(jops, jdat, "block3"),
                                     jnp.asarray(r, jd)))
    got = tops.apply_prec(make_prec(tops, tdat, "block3"),
                          torch.as_tensor(r, dtype=td), tdat).numpy()
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())
    # the node rows are the structured layout's (component-major)
    z3 = tops._as_node3(torch.as_tensor(got))
    assert torch.equal(tops._from_node3(z3), torch.as_tensor(got))


def blocks_with_edge_cases(rng, n=24):
    R = rng.normal(size=(n, 3, 3))
    B = R @ R.transpose(0, 2, 1) + 0.5 * np.eye(3)
    eff = (rng.random((n, 3)) < 0.8).astype(float)
    # rank-deficient block (det exactly 0), and a zero diagonal on a free
    # dof (scalar fallback; 1/0 = inf, the flag-2 contract)
    B[0] = [[2.0, 4.0, 0.0], [4.0, 8.0, 0.0], [0.0, 0.0, 8.0]]
    B[1] = np.diag([2.0, 0.0, 5.0])
    eff[:2] = 1.0
    # an ill-conditioned but valid rotated SPD block (det ~1e-7)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    B[2] = (q * np.array([1.0, 3e-4, 3e-4])) @ q.T
    eff[2] = 1.0
    # a fully fixed node
    eff[3] = 0.0
    return B[None], eff[None]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_invert_node_blocks_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    B, eff = blocks_with_edge_cases(np.random.default_rng(11))
    B, eff = B.astype(dtype), eff.astype(dtype)
    ref = np.asarray(jax_invert(jnp.asarray(B), jnp.asarray(eff)))
    got = invert_node_blocks(torch.as_tensor(B), torch.as_tensor(eff))
    assert got.dtype == td
    got = got.numpy()
    rtol = 1e-12 if dtype == "float64" else 2e-7
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    # the edge cases behave as the JAX package documents them
    np.testing.assert_allclose(got[0, 0], np.diag([0.5, 0.125, 0.125]),
                               rtol=rtol)
    np.testing.assert_array_equal(np.isinf(got[0, 1]),
                                  np.diag([False, True, False]))
    assert np.abs(B[0, 2] @ got[0, 2] - np.eye(3)).max() < 5e-3
    np.testing.assert_array_equal(got[0, 3], np.eye(3))


def test_scalar_and_mg_operands_and_fallback_kind(both):
    jops, jdat, tops, tdat = both["float64"]
    inv = make_prec(tops, tdat, "jacobi")
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(jax_make_prec(jops, jdat,
                                                        "jacobi")),
                               rtol=1e-14, atol=0)
    m = make_prec(tops, tdat, "mg")
    assert set(m) == {"mg_diag", "fb"} and int(m["fb"]) == 0
    assert torch.equal(m["mg_diag"], inv)
    for kind in ("jacobi", "block3", "mg"):
        assert fallback_kind(kind) == jax_fallback_kind(kind)
    with pytest.raises(ValueError, match="precond must be one of"):
        make_prec(tops, tdat, "ilu")
