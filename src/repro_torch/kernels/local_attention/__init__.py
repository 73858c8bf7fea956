from repro_torch.kernels.local_attention.kernel import local_attention_cuda  # noqa: F401
from repro_torch.kernels.local_attention.ops import local_attention  # noqa: F401
from repro_torch.kernels.local_attention.ref import local_attention_ref  # noqa: F401
