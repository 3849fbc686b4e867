from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.models.synthetic import make_cube_model

__all__ = ["ModelData", "make_cube_model"]
