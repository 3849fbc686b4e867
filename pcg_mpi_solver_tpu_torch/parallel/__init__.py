from pcg_mpi_solver_tpu_torch.parallel.partition import (
    PartitionedModel, partition_from_numpy, partition_model)

__all__ = ["PartitionedModel", "partition_from_numpy", "partition_model"]
