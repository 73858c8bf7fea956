"""repro_torch.sharding — the serving die mesh.

``mesh.DieMesh`` partitions the slot pool over N independently aging
STT-RAM dies (the serving half of ``repro.sharding``). The device
placement (``device_mesh``, ``sharding_for``), the training meshes and
``rules`` come with training."""
from repro_torch.sharding.mesh import DIE_AXIS, DieMesh, uniform  # noqa: F401

__all__ = ["DIE_AXIS", "DieMesh", "uniform"]
