"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 80GB (the data sheet, dense, without sparsity, at the
card's full 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s float32 outside the
tensor cores. A roofline share is taken against these
numbers whatever the card's power limit; the run prints the limit beside
it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}


def peaks_of(kind: str) -> dict | None:
    """The peaks of the card named `kind` (`torch.cuda.get_device_name`),
    or None for a card not in the table."""
    return PEAKS.get(kind)
