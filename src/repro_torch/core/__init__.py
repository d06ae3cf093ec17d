"""BLMAC core for the port: the CSD codec, the §3.2 quantizer and the
durable-file helpers — numpy copies of the `repro.core` pieces the
filter-bank path needs."""
from .csd import (
    assert_int32_bound,
    csd_decode,
    csd_digits,
    layer_occupancy,
    occupancy_signatures,
    pack_trits,
    packed_pulse_counts,
    require_type1,
    unpack_trits,
)
from .quantize import po2_quantize_batch

__all__ = [
    "assert_int32_bound",
    "csd_decode",
    "csd_digits",
    "layer_occupancy",
    "occupancy_signatures",
    "pack_trits",
    "packed_pulse_counts",
    "po2_quantize_batch",
    "require_type1",
    "unpack_trits",
]
