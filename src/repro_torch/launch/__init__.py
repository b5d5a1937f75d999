"""Process-group meshes for sharded serving (``launch/mesh.py``)."""
from .mesh import Mesh, make_local_mesh

__all__ = ["Mesh", "make_local_mesh"]
