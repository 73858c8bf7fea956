from repro_torch.kernels.scrub.kernel import scrub_cuda  # noqa: F401
from repro_torch.kernels.scrub.ops import scrub_write  # noqa: F401
from repro_torch.kernels.scrub.ref import scrub_ref  # noqa: F401
