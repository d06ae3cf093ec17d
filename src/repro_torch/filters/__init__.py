"""FIR filter substrate of the port: bank design (scipy-compatible
windowed sinc), the paper's §3.1 sweep bank, the exact numpy oracles and
the streaming overlap-save `FilterBankEngine` on the GPU."""
from .apply import fir_bit_layers, fir_bit_layers_batch, fir_direct, sliding_windows
from .bank import FilterBankEngine
from .fir import (FilterKind, bands_for, design_bank, firwin_batch,
                  spread_lowpass_qbank, window_values)
from .sweep import TAPS_RANGE, SweepSpec, sweep_bank, sweep_specs

__all__ = [
    "FilterBankEngine",
    "FilterKind",
    "SweepSpec",
    "TAPS_RANGE",
    "bands_for",
    "design_bank",
    "fir_bit_layers",
    "fir_bit_layers_batch",
    "fir_direct",
    "firwin_batch",
    "sliding_windows",
    "spread_lowpass_qbank",
    "sweep_bank",
    "sweep_specs",
    "window_values",
]
