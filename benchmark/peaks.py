"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit)."""

DENSE_OPS_PER_S = {
    "bf16": 989e12,
    "fp16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "fp32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12
