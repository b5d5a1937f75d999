"""Process-group meshes and the production mesh's description
(``launch/mesh.py``), the training and serving launchers
(``launch/train.py``, ``launch/serve.py``), the dry run
(``launch/dryrun.py``) and its perf variants (``launch/perf_variants.py``)."""
from .mesh import (AXES, Mesh, MeshAxis, MeshDesc, data_axes_for,
                   local_device, make_local_mesh, make_production_mesh)

__all__ = ["AXES", "Mesh", "MeshAxis", "MeshDesc", "data_axes_for",
           "local_device", "make_local_mesh", "make_production_mesh"]
