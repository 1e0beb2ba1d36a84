"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense rates, the full power limit). Keyed by a substring of
``torch.cuda.get_device_name()``."""

#: (name substring, HBM bytes/s)
HBM_BYTES_PER_S = (
    ("H100", 3.35e12),  # H100 SXM5 80GB HBM3
)


def hbm_bytes_per_s(device_name: str):
    """The card's published memory bandwidth, or None if unknown."""
    return next((bw for sub, bw in HBM_BYTES_PER_S if sub in device_name),
                None)
