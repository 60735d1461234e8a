"""Mesh layer of the port: structured and unstructured triangulations,
gmsh files, topology, MeshData."""

from airpollution_tpu_torch.mesh.data import MeshData, structured_grid
from airpollution_tpu_torch.mesh.msh_io import read_msh, write_msh
from airpollution_tpu_torch.mesh.structured import (Mesh, create_mesh,
                                                   create_unstructured_mesh)

__all__ = ["Mesh", "MeshData", "create_mesh", "create_unstructured_mesh",
           "read_msh", "structured_grid", "write_msh"]
