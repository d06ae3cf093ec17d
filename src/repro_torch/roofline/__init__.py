"""Roofline analysis of the port: the operator-level counterpart of
`repro.roofline` (see `op_analysis`)."""
from .op_analysis import (COLLECTIVE_KINDS, CompCost, OpCounter,
                          analyze_step, collective_link_bytes)

__all__ = ["COLLECTIVE_KINDS", "CompCost", "OpCounter", "analyze_step",
           "collective_link_bytes"]
