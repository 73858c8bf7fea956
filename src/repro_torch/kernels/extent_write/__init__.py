from repro_torch.kernels.extent_write.kernel import extent_write_cuda  # noqa: F401
from repro_torch.kernels.extent_write.ops import extent_write, level_vectors  # noqa: F401
from repro_torch.kernels.extent_write.ref import extent_write_ref  # noqa: F401
