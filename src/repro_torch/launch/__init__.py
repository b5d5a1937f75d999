"""Process-group meshes (``launch/mesh.py``) and the training launcher
(``launch/train.py``)."""
from .mesh import AXES, Mesh, MeshAxis, local_device, make_local_mesh

__all__ = ["AXES", "Mesh", "MeshAxis", "local_device", "make_local_mesh"]
