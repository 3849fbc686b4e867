from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model
from pcg_mpi_solver_tpu_torch.models.synthetic import (
    make_cube_model, make_glued_blocks_model, make_poisson_model)

__all__ = ["ModelData", "make_cube_model", "make_glued_blocks_model",
           "make_octree_model", "make_poisson_model"]
