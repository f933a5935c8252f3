"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): HBM3 bytes a second and operations a second by type."""

HBM_BPS = 3.35e12
F32_OPS = 67e12
TF32_OPS = 495e12
BF16_OPS = 989e12
INT8_OPS = 1979e12


def bound_ms(n_bytes: float, ops: float, peak_ops: float = F32_OPS) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over their peak."""
    return 1e3 * max(n_bytes / HBM_BPS, ops / peak_ops)
