"""NVIDIA H100 SXM5 constants for roofline accounting (the port's target
card), each cited beside it.

``PEAK_FLOPS_BF16`` and ``HBM_BW`` keep the reference's names
(``repro.launch.hw`` holds its TPU's); the constants that mean something
else on a GPU have GPU names.
"""

#: dense BF16 tensor-core FLOP/s — NVIDIA H100 Tensor Core GPU data
#: sheet, H100 SXM: 1,979 TFLOPS with sparsity, half of it dense
PEAK_FLOPS_BF16 = 989e12
#: FP32 FLOP/s outside the tensor cores — the same data sheet: 67 TFLOPS
PEAK_FLOPS_F32 = 67e12
#: HBM3 bytes/s — the same data sheet: 3.35 TB/s
HBM_BW = 3.35e12
#: NVLink bytes/s per link — the same data sheet's 900 GB/s over the 18
#: fourth-generation links of the NVIDIA H100 architecture white paper
NVLINK_BW_PER_LINK = 50e9
#: GPUs of one HGX H100 node, all to all over NVSwitch — NVIDIA HGX H100
#: data sheet: 8
GPUS_PER_NODE = 8
