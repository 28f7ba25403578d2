"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit). A roofline share is
stated against these, with the card's power limit printed beside it."""

from __future__ import annotations

PEAKS = {
    # float32 outside the tensor cores, and HBM3 bandwidth
    "H100": dict(f32_flops=67e12, bytes_per_s=3.35e12),
}


def for_card(name: str) -> dict | None:
    """The peaks of the card named `name` (torch.cuda.get_device_name), or
    None for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory peak."""
    return max(ops / peaks["f32_flops"], nbytes / peaks["bytes_per_s"])
