"""Published peaks of the cards the benchmark runs on, by the exact name
that ``torch.cuda.get_device_name`` gives: NVIDIA's data sheet for the
H100 SXM5 part (132 SMs, 1.98 GHz boost clock) at its 700 W power limit.
A card not in the table has no peaks, and the metrics that need them are
left out of its runs."""

#: SMs and boost clock of the H100 SXM5
_SM, _CLOCK = 132, 1.98e9

#: card name -> float32 FLOP/s outside the tensor cores (128 lanes an SM,
#: an FMA 2), special-function results a second (16 a clock an SM), HBM
#: bytes a second
TABLE = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "sfu": _SM * 16 * _CLOCK,
                              "bytes": 3.35e12},
}


def peaks(kind: str):
    """{"flops", "sfu", "bytes"} of the card named `kind`, or None."""
    row = TABLE.get(kind)
    return None if row is None else dict(row)
