"""The port's model generator and slab partition against the JAX package's:
every array must be bit-identical, so the two solvers run on the same
inputs (tolerance: none — equal bytes, equal dtypes)."""

import dataclasses

import numpy as np
import pytest

from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.parallel.structured import (
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu_torch.models.element import HEX_CORNERS
from pcg_mpi_solver_tpu_torch.models.synthetic import make_cube_model
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredPartition, partition_from_numpy, partition_structured)


def assert_same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


CASES = [
    ((6, 5, 4), dict(load="traction", heterogeneous=True, seed=11)),
    ((7, 3, 5), dict(load="dirichlet", load_value=1e-3, heterogeneous=True,
                     seed=3)),
    ((4, 4, 4), dict(load="traction", E=30e9, load_value=1e6)),
    ((10, 8, 8), dict(load="dirichlet", heterogeneous=True, h=0.5, nu=0.3)),
]


@pytest.mark.parametrize("dims,kw", CASES)
def test_cube_model_bitwise(dims, kw):
    mj = jax_cube(*dims, **kw)
    mt = make_cube_model(*dims, **kw)
    for f in dataclasses.fields(mt):
        assert_same(getattr(mt, f.name), getattr(mj, f.name), f.name)
    if kw.get("heterogeneous"):
        assert len(np.unique(mt.ck)) == 2     # the two phases are present


@pytest.mark.parametrize("dims,kw", CASES)
@pytest.mark.parametrize("split", ["one", "many"])
def test_partition_bitwise(dims, kw, split):
    # "many": the smallest part count > 1 that divides nx (7 slabs of one
    # cell for the (7, 3, 5) cube)
    n_parts = 1 if split == "one" else min(
        p for p in range(2, dims[0] + 1) if dims[0] % p == 0)
    spj = jax_partition(jax_cube(*dims, **kw), n_parts)
    spt = partition_structured(make_cube_model(*dims, **kw), n_parts)
    for f in dataclasses.fields(spt):
        assert_same(getattr(spt, f.name), getattr(spj, f.name), f.name)


def test_partition_from_numpy_round_trip():
    spj = jax_partition(jax_cube(6, 5, 4, heterogeneous=True, seed=2), 2)
    arrays = {f.name: getattr(spj, f.name)
              for f in dataclasses.fields(spj)}
    sp = partition_from_numpy(arrays)
    assert isinstance(sp, StructuredPartition)
    for f in dataclasses.fields(sp):
        assert_same(getattr(sp, f.name), arrays[f.name], f.name)
    again = partition_from_numpy(dataclasses.asdict(sp))
    for f in dataclasses.fields(sp):
        assert_same(getattr(again, f.name), getattr(sp, f.name), f.name)


def test_partition_from_numpy_rejects_bad_shapes():
    spj = jax_partition(jax_cube(4, 3, 3), 1)
    arrays = {f.name: getattr(spj, f.name)
              for f in dataclasses.fields(spj)}
    with pytest.raises(ValueError, match="missing"):
        partition_from_numpy({k: v for k, v in arrays.items() if k != "F"})
    with pytest.raises(ValueError, match="ck"):
        partition_from_numpy(dict(arrays, ck=arrays["ck"][:, :-1]))


def test_hex_corners_vtk_order():
    from pcg_mpi_solver_tpu.models.element import HEX_CORNERS as JAX_CORNERS

    assert_same(HEX_CORNERS, JAX_CORNERS, "HEX_CORNERS")
