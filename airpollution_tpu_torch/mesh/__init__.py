"""Mesh layer of the port: structured and unstructured triangulations,
gmsh files, edge topology and ELL patterns, MeshData."""

from airpollution_tpu_torch.mesh.data import MeshData, structured_grid
from airpollution_tpu_torch.mesh.msh_io import read_msh, write_msh
from airpollution_tpu_torch.mesh.structured import (Mesh, create_mesh,
                                                   create_unstructured_mesh)
from airpollution_tpu_torch.mesh.topology import (EdgeTopology, EllPattern,
                                                  build_ell_pattern,
                                                  enumerate_edges)

__all__ = ["EdgeTopology", "EllPattern", "Mesh", "MeshData",
           "build_ell_pattern", "create_mesh", "create_unstructured_mesh",
           "enumerate_edges", "read_msh", "structured_grid", "write_msh"]
