"""Published peaks of the cards the benchmark knows (dense rates, no
sparsity), at the card's full power limit: NVIDIA's H100 SXM data sheet.
A share of a peak is stated against these, with the card's power limit
beside it."""
from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(device_name: str) -> Dict[str, float]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no published peaks for {device_name!r}")


def bound_s(flops: float, nbytes: float, p: Dict[str, float]) -> float:
    """The least time the card could take for this work."""
    return max(flops / p["bf16_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
