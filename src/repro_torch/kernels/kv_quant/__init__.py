from repro_torch.kernels.kv_quant.kernel import kv_quant_cuda  # noqa: F401
from repro_torch.kernels.kv_quant.ops import kv_dequant, kv_quant_store  # noqa: F401
from repro_torch.kernels.kv_quant.ref import kv_quant_ref  # noqa: F401
