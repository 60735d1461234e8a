"""Seconds in the set-up's mesh span: ``mesh.structured.create_mesh`` and
``mesh.data.MeshData`` (``mesh.topology``, ``mesh.native``), until the
mesh's tensors are on the device."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "set-up: mesh"
MOVES = "setup_s"


def read(ctx):
    return ctx["spans"].get("mesh_setup")
