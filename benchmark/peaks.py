"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense rates, the full power limit). Keyed by a substring of
``torch.cuda.get_device_name()``."""

#: (name substring, HBM bytes/s)
HBM_BYTES_PER_S = (
    ("H100", 3.35e12),  # H100 SXM5 80GB HBM3
)

#: dtype name -> ((name substring, dense tensor-core FLOP/s), ...)
FLOPS_PER_S = {
    "bfloat16": (("H100", 989e12),),  # H100 SXM5, dense BF16
}


def hbm_bytes_per_s(device_name: str):
    """The card's published memory bandwidth, or None if unknown."""
    return next((bw for sub, bw in HBM_BYTES_PER_S if sub in device_name),
                None)


def flops_per_s(device_name: str, dtype: str):
    """The card's published dense peak for products in ``dtype``, or
    None if the card or the dtype is not in the table."""
    return next((f for sub, f in FLOPS_PER_S.get(dtype, ())
                 if sub in device_name), None)
