"""repro_torch.sharding — device meshes and the training sharding rules.

``mesh.DieMesh`` partitions the slot pool over N independently aging
STT-RAM dies (serving); ``mesh.Mesh`` with ``make_production_mesh`` /
``make_host_mesh`` are the training meshes, and ``rules`` maps logical
axes onto them. On one H100 every mesh folds onto the card."""
from repro_torch.sharding import rules  # noqa: F401
from repro_torch.sharding.mesh import (DIE_AXIS, DieMesh, Mesh,  # noqa: F401
                                       NamedSharding, make_host_mesh,
                                       make_production_mesh, uniform)

__all__ = ["DIE_AXIS", "DieMesh", "Mesh", "NamedSharding", "make_host_mesh",
           "make_production_mesh", "rules", "uniform"]
