"""The port's MDF bundle reader/writer against the JAX package's (CPU).

- A bundle written by the JAX package's ``write_mdf`` reads in the port
  with every ``ModelData`` field equal to what the JAX package's
  ``read_mdf`` gives (bytes and dtypes), and a bundle the port writes
  reads back in the JAX package to the same model: a structured cube
  (``Grid.npz``), an octree (``Octree.npz``) and glued blocks
  (``Intfc.npz``).
- ``reconstruct_lattice_meta``: a bundle without its sidecars (what the
  reference's meshing pipeline writes) gets the same octree metadata, and
  the same grid, in both packages.
- ``ingest_archive`` unpacks a zipped bundle where the JAX package does;
  the sharded ingest's entry points refuse, naming ROADMAP queue 1 item
  12; the scalar class is refused by the writer.
"""

import os
import shutil

import numpy as np
import pytest

from pcg_mpi_solver_tpu.models import mdf as jax_mdf
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import (
    make_cube_model as jax_cube, make_glued_blocks_model as jax_glued)
from pcg_mpi_solver_tpu_torch.models import (
    make_cube_model, make_glued_blocks_model, make_octree_model,
    make_poisson_model)
from pcg_mpi_solver_tpu_torch.models import mdf
from pcg_mpi_solver_tpu_torch.models.model_data import SparseVec
from pcg_mpi_solver_tpu_torch.models.octree import reconstruct_lattice_meta

from test_torch_partition import assert_same

MODELS = {
    "cube": lambda pkg: (jax_cube if pkg == "jax" else make_cube_model)(
        5, 4, 3, heterogeneous=True, seed=2, load="traction"),
    "octree": lambda pkg: (jax_octree if pkg == "jax" else make_octree_model)(
        2, 2, 2, max_level=2, n_incl=2, seed=3, load="traction"),
    "glued": lambda pkg: (jax_glued if pkg == "jax"
                          else make_glued_blocks_model)(3, 2, 3, 3),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bundles_cross_read_in_both_directions(tmp_path, name):
    mj, mt = MODELS[name]("jax"), MODELS[name]("port")
    jax_mdf.write_mdf(mj, str(tmp_path / "j"))
    mdf.write_mdf(mt, str(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "t"))
    for f in os.listdir(tmp_path / "j"):
        if f.endswith((".bin", ".npz")):
            a = (tmp_path / "j" / f).read_bytes()
            b = (tmp_path / "t" / f).read_bytes()
            assert a == b or f.endswith(".npz"), f
    ref = jax_mdf.read_mdf(str(tmp_path / "j"))
    assert_same(mdf.read_mdf(str(tmp_path / "j")), ref, f"{name} jax->port")
    assert_same(mdf.read_mdf(str(tmp_path / "t")),
                jax_mdf.read_mdf(str(tmp_path / "t")), f"{name} port->jax")
    assert_same(mdf.read_mdf(str(tmp_path / "t")), ref, f"{name} both")


@pytest.mark.parametrize("name", ["cube", "octree"])
def test_reconstruct_lattice_meta_matches_jax(tmp_path, name):
    """Sidecars removed: the reader rebuilds the octree (and, for the
    full uniform box, the grid) from the schema's own geometry."""
    mj = MODELS[name]("jax")
    jax_mdf.write_mdf(mj, str(tmp_path))
    for f in ("Grid.npz", "Octree.npz"):
        if (tmp_path / f).exists():
            os.remove(tmp_path / f)
    got, want = mdf.read_mdf(str(tmp_path)), jax_mdf.read_mdf(str(tmp_path))
    assert got.octree is not None and want.octree is not None
    assert_same(got.octree, want.octree, f"{name} octree")
    assert got.grid == want.grid
    assert (got.grid is not None) == (name == "cube")
    # a model that is no lattice keeps its general-path eligibility
    m = MODELS[name]("port")
    m.octree, m.grid = None, None
    m.node_coords = m.node_coords + np.random.default_rng(0).uniform(
        0, 1e-2, m.node_coords.shape)
    assert reconstruct_lattice_meta(m) is False and m.octree is None


def test_ingest_archive_and_refusals(tmp_path):
    m = MODELS["cube"]("port")
    mdf.write_mdf(m, str(tmp_path / "src"))
    archive = shutil.make_archive(str(tmp_path / "cube"), "zip",
                                  tmp_path / "src")
    got = mdf.ingest_archive(archive, str(tmp_path / "scratch"))
    want = jax_mdf.ingest_archive(archive, str(tmp_path / "scratch_j"))
    assert os.path.relpath(got, tmp_path / "scratch") == os.path.relpath(
        want, tmp_path / "scratch_j") == os.path.join("ModelData", "MDF")
    assert_same(mdf.read_mdf(got), jax_mdf.read_mdf(want), "ingest")
    # the sharded ingest (once refused, naming ROADMAP queue 1 item 12):
    # the same slab ids and the same sparse slab view as the JAX package
    for k in range(2):
        np.testing.assert_array_equal(mdf.slab_elem_ids(got, k, 2),
                                      jax_mdf.slab_elem_ids(want, k, 2))
        mt, mj = mdf.read_mdf_slab(got, k, 2), jax_mdf.read_mdf_slab(want,
                                                                     k, 2)
        np.testing.assert_array_equal(mt.elem_ids, mj.elem_ids)
        for name in ("F", "Ud", "node_coords"):
            np.testing.assert_array_equal(getattr(mt, name).materialize(),
                                          getattr(mj, name).materialize())
    sv = SparseVec(np.arange(2), np.ones(2), 4)
    np.testing.assert_array_equal(sv[np.arange(4)], [1.0, 1.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="scalar"):
        mdf.write_mdf(make_poisson_model(2, 2, 2), str(tmp_path / "p"))
