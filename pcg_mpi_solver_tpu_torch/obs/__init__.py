from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder

__all__ = ["MetricsRecorder"]
