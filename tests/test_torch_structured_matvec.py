"""The port's structured matvec (plain version + wrapper) and StructuredOps
against the JAX package on the CPU, on bit-identical inputs.

Tolerances: float32 rtol/atol 2e-5, the tolerances of tests/test_pallas.py
(the einsum and the eight-translate sum round in another order than
XLA's); float64 1e-12 * max|y| (round-off of a 576-term sum per cell)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops.matvec import Ops as JaxOps
from pcg_mpi_solver_tpu.ops import pallas_matvec as jax_pallas
from pcg_mpi_solver_tpu.ops.pallas_matvec import structured_matvec_pallas_v6
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)

F32 = dict(rtol=2e-5, atol=2e-5)


DIMS = [(6, 5, 4), (4, 4, 4), (7, 3, 5)]


def both(dims, n_parts=1, seed=11, dtype="float64"):
    """The same partition in both packages: JAX ops/data, port ops/data."""
    spj = jax_partition(jax_cube(*dims, heterogeneous=True, seed=seed),
                        n_parts)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "float64": (jnp.float64, torch.float64)}[dtype]
    jops = JaxStructuredOps.from_partition(spj, dot_dtype=jdt)
    tops = StructuredOps.from_partition(sp, dot_dtype=tdt)
    return (jops, jax_data(spj, jdt)), (tops,
                                       device_data_structured(sp, tdt, "cpu"))


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_jax_float32(dims):
    (jops, jd), (tops, td) = both(dims, dtype="float32")
    x = np.random.default_rng(3).normal(size=(1, tops.n_loc)) \
        .astype(np.float32)
    y_ref = np.asarray(jops.matvec_local(jd, jnp.asarray(x)))
    y = tops.matvec_local(td, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, **F32)


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_jax_float64(dims):
    (jops, jd), (tops, td) = both(dims)
    x = np.random.default_rng(5).normal(size=(1, tops.n_loc))
    y_ref = np.asarray(jops.matvec_local(jd, jnp.asarray(x)))
    y = tops.matvec_local(td, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())


@pytest.mark.parametrize("dims,planes", [((6, 5, 4), 2), ((4, 4, 4), 4),
                                         ((7, 3, 5), 3), ((5, 4, 3), 8)])
def test_plain_matches_pallas_v6_interpret(dims, planes):
    """Against the TPU kernel itself, run through the Pallas interpreter
    exactly as tests/test_pallas.py runs it."""
    nx, ny, nz = dims
    (_jops, jd), (_tops, td) = both(dims, dtype="float32")
    blk = jd["blocks"][0]
    xg = np.random.default_rng(3).normal(
        size=(3, nx + 1, ny + 1, nz + 1)).astype(np.float32)
    y_ref = np.asarray(structured_matvec_pallas_v6(
        jnp.asarray(xg), blk["ck"][0], blk["Ke"], interpret=True,
        planes=planes))
    tb = td["blocks"][0]
    y = smv.structured_matvec_plain(torch.from_numpy(xg)[None], tb["ck"],
                                    tb["Ke"])[0].numpy()
    np.testing.assert_allclose(y, y_ref, **F32)


# the TPU kernels each ported variant replaces, with the chunk sizes that
# apply (v1 and v2 march one plane a step and take none; v6 has its own
# test above)
PORTED_PALLAS = [("v1", jax_pallas.structured_matvec_pallas, None),
                 ("v2", jax_pallas.structured_matvec_pallas_v2, None)] + [
    (v, getattr(jax_pallas, f"structured_matvec_pallas_{v}"), planes)
    for v in ("v3", "v4", "v5", "v7", "v8", "v9") for planes in (8, 16)]


@pytest.mark.parametrize("variant,fn,planes", PORTED_PALLAS,
                         ids=[f"{v}-planes{p}" for v, _f, p in PORTED_PALLAS])
@pytest.mark.parametrize("dims,masked", [(d, False) for d in DIMS]
                         + [((4, 3, 3), True)])
def test_plain_matches_ported_pallas_variants_interpret(variant, fn, planes,
                                                        dims, masked):
    """The plain version (every kernel's reference) against the TPU
    kernels v1-v5 and v7-v9 through the Pallas interpreter, on the shapes
    of tests/test_pallas.py; ``masked`` zeroes the far-z cells, as its
    isolation case does."""
    nx, ny, nz = dims
    (_jops, jd), (_tops, td) = both(dims, dtype="float32")
    ck = np.asarray(jd["blocks"][0]["ck"]).copy()
    if masked:
        ck[:, :, :, -1] = 0.0
    xg = np.random.default_rng(3).normal(
        size=(3, nx + 1, ny + 1, nz + 1)).astype(np.float32)
    kw = {} if planes is None else dict(planes=planes)
    y_ref = np.asarray(fn(jnp.asarray(xg), jnp.asarray(ck[0]),
                          jd["blocks"][0]["Ke"], interpret=True, **kw))
    y = smv.structured_matvec_plain(torch.from_numpy(xg)[None],
                                    torch.from_numpy(ck),
                                    td["blocks"][0]["Ke"])[0].numpy()
    np.testing.assert_allclose(y, y_ref, **F32)


def test_zero_ck_cells_isolated():
    """Cells with ck = 0 contribute nothing (tests/test_pallas.py's
    isolation case), against the JAX XLA path and the v6 kernel."""
    (jops, jd), (_tops, td) = both((4, 3, 3), seed=1, dtype="float32")
    jblk = jd["blocks"][0]
    ck_masked = np.asarray(jblk["ck"]).copy()
    ck_masked[:, :, :, -1] = 0.0
    xg = np.random.default_rng(9).normal(size=(3, 5, 4, 4)) \
        .astype(np.float32)
    jd2 = dict(jd, blocks=[{**jblk, "ck": jnp.asarray(ck_masked)}])
    y_xla = np.asarray(jops.matvec_local(jd2, jnp.asarray(xg.reshape(1, -1))))
    y_v6 = np.asarray(structured_matvec_pallas_v6(
        jnp.asarray(xg), jnp.asarray(ck_masked[0]), jblk["Ke"],
        interpret=True))
    y = smv.structured_matvec_plain(
        torch.from_numpy(xg)[None], torch.from_numpy(ck_masked),
        td["blocks"][0]["Ke"]).numpy()
    np.testing.assert_allclose(y.reshape(1, -1), y_xla, **F32)
    np.testing.assert_allclose(y[0], y_v6, **F32)
    # and the mask bit: with the far-z cells live the result differs
    y_full = smv.structured_matvec_plain(
        torch.from_numpy(xg)[None], td["blocks"][0]["ck"].float(),
        td["blocks"][0]["Ke"])
    assert not np.allclose(y_full.numpy(), y)


def test_multi_part_matvec_diag_halo_match_jax():
    """n_parts = 2 on one device: the unsharded roll-view halo, the
    assembled matvec and the assembled diagonal, in float64."""
    (jops, jd), (tops, td) = both((8, 3, 5), n_parts=2)
    x = np.random.default_rng(7).normal(size=(2, tops.n_loc))
    y_ref = np.asarray(jops.matvec(jd, jnp.asarray(x)))
    y = tops.matvec(td, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())
    d_ref = np.asarray(jops.diag(jd))
    d = tops.diag(td).numpy()
    np.testing.assert_allclose(d, d_ref, rtol=1e-14, atol=0)
    g = np.random.default_rng(8).normal(size=(2, 3, 5, 4, 6))
    h_ref = np.asarray(jops._halo(jnp.asarray(g)))
    h = tops._halo(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(h, h_ref)


@pytest.mark.parametrize("dot", ["float32", "float64"])
def test_weighted_dots_match_jax(dot):
    """wdot / wdots: operands cast to the dot dtype BEFORE the multiply
    (f32 storage, f64 accumulation stays exact per product).  Summation
    order differs from XLA's: rtol 1e-5 for f32 sums, 1e-12 for f64."""
    rng = np.random.default_rng(4)
    w = (rng.random((2, 500)) > 0.2).astype(np.float32)
    a, b = (rng.normal(size=(2, 500)).astype(np.float32) for _ in range(2))
    jo = JaxOps(n_loc=500, n_iface=0, dot_dtype=jnp.dtype(dot))
    to = Ops(n_loc=500, n_iface=0, dot_dtype=getattr(torch, dot))
    rtol = 1e-5 if dot == "float32" else 1e-12
    ref = np.asarray(jo.wdots(jnp.asarray(w), [(jnp.asarray(a),
                                                 jnp.asarray(b)),
                                                (jnp.asarray(a),
                                                 jnp.asarray(a))],
                              extra=[3.0]))
    got = to.wdots(torch.from_numpy(w), [(torch.from_numpy(a),
                                          torch.from_numpy(b)),
                                         (torch.from_numpy(a),
                                          torch.from_numpy(a))],
                   extra=[3.0])
    assert got.dtype == getattr(torch, dot)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol)
    one = to.wdot(torch.from_numpy(w), torch.from_numpy(a),
                  torch.from_numpy(b))
    np.testing.assert_allclose(one.numpy(), ref[0], rtol=rtol)


def test_wrapper_cpu_takes_plain_path_and_counts_nothing():
    (_jops, _jd), (tops, td) = both((4, 4, 4))
    blk = td["blocks"][0]
    xg = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, 5, 5, 5)))
    before = dict(smv.LAUNCHES)
    y = smv.structured_matvec(xg, blk["ck"], blk["Ke"])
    assert smv.LAUNCHES == before
    assert torch.equal(y, smv.structured_matvec_plain(xg, blk["ck"],
                                                      blk["Ke"]))


@pytest.mark.parametrize("variant", sorted(smv.VARIANTS))
def test_wrapper_cpu_plain_path_for_every_variant(variant):
    """On a CPU tensor every variant (and any planes) takes the plain
    version and launches nothing."""
    (_jops, _jd), (_tops, td) = both((5, 4, 3), dtype="float32")
    blk = td["blocks"][0]
    xg = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 3, 6, 5, 4)).astype(np.float32))
    before = dict(smv.LAUNCHES)
    y = smv.structured_matvec(xg, blk["ck"], blk["Ke"], variant=variant,
                              planes=16)
    assert smv.LAUNCHES == before
    assert torch.equal(y, smv.structured_matvec_plain(xg, blk["ck"],
                                                      blk["Ke"]))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (_jops, _jd), (_tops, td) = both((4, 4, 4))
    blk = td["blocks"][0]
    xg = torch.zeros((1, 3, 5, 5, 5), dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        smv.structured_matvec(xg.float(), blk["ck"], blk["Ke"])
    with pytest.raises(ValueError, match="contiguous"):
        smv.structured_matvec(xg.transpose(2, 4), blk["ck"], blk["Ke"])
    with pytest.raises(ValueError, match="ck must be"):
        smv.structured_matvec(xg, blk["ck"][:, :-1], blk["Ke"])
    with pytest.raises(ValueError, match="Ke must be"):
        smv.structured_matvec(xg, blk["ck"], blk["Ke"][:8])
    with pytest.raises(TypeError, match="dtype"):
        smv.structured_matvec(xg.half(), blk["ck"].half(), blk["Ke"].half())
    for bad in ("v0", "v10", "6", "xla"):
        with pytest.raises(ValueError, match="variant must be"):
            smv.structured_matvec(xg, blk["ck"], blk["Ke"], variant=bad)
