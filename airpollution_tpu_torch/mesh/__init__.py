"""Mesh layer of the port: structured triangulation, topology, MeshData."""

from airpollution_tpu_torch.mesh.data import MeshData, structured_grid
from airpollution_tpu_torch.mesh.structured import Mesh, create_mesh

__all__ = ["Mesh", "MeshData", "create_mesh", "structured_grid"]
