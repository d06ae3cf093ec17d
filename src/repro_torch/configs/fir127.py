"""The paper's own configuration (§4): the 127-tap BLMAC dot-product
machine and its filter workload."""
from dataclasses import dataclass


@dataclass(frozen=True)
class FirConfig:
    taps: int = 127
    coeff_bits: int = 16
    sample_bits: int = 8
    weight_mem_codes: int = 256
    n_div: int = 100          # frequency grid of the §3.1 sweep
    window: str = "hamming"
    kaiser_beta: float = 8.0  # calibrated against the paper's B_N
    kernel_tile: int = 1024   # Pallas output tile (lanes)


CONFIG = FirConfig()
