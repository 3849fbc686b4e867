from pcg_mpi_solver_tpu_torch.vtk.writer import write_vtu, VTK_HEXAHEDRON, VTK_POLYGON, VTK_QUAD, VTK_TETRA

__all__ = ["write_vtu", "VTK_HEXAHEDRON", "VTK_POLYGON", "VTK_QUAD", "VTK_TETRA"]
