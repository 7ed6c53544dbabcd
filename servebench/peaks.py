"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), by a substring of ``torch.cuda.get_device_name()``.

NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16, 1979 TFLOP/s e4m3, 3.35 TB/s
of HBM3, at the full 700 W power limit; NVLink 900 GB/s a GPU, both
directions together: 450 GB/s a direction.
"""

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp8_flops": 1979e12, "hbm_bytes": 3.35e12, "nvlink_bytes": 450e9},
}


def peaks_of(device_name: str):
    """The peaks of the card named ``device_name``, or None when the table
    has none (a roofline share is then not reported)."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None
