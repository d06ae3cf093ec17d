"""Production meshes, the reference's shapes (`repro.launch.mesh`).

One pod is arranged as (data=16, model=16); the multi-pod deployment
stacks pods on a leading ``pod`` axis that folds into data parallelism.
The slots are ``meta`` devices by default: a mesh of this size is for a
shape-only dry run (the placement of every leaf, no storage); pass
``devices=`` for a mesh that holds data.  Functions, not module
constants: importing this module touches no device.
"""
from __future__ import annotations

import math

from ..distributed.sharding import Mesh, make_mesh

__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_FLOPS_BF16",
           "make_production_mesh", "make_test_mesh"]


def _meta(shape) -> list:
    import torch

    return [torch.device("meta")] * math.prod(shape)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes,
                     devices if devices is not None else _meta(shape))


def make_test_mesh(n_data: int = 2, n_model: int = 2, devices=None) -> Mesh:
    """A small (data, model) mesh, on ``meta`` slots unless ``devices``
    are given."""
    shape = (n_data, n_model)
    return make_mesh(shape, ("data", "model"),
                     devices if devices is not None else _meta(shape))


# The card the roofline analysis (`repro_torch.launch.dryrun`) prices a
# slot against: the NVIDIA H100 80GB HBM3 SXM at its 700 W limit, from
# its data sheet (the figures `chip_smoke.py`'s bounds use).  A 256-card
# mesh spans nodes, whose links are slower than NVLink; one link rate
# for every collective is the same simplification as the reference's
# single inter-chip rate.
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12  # bytes/s a card
NVLINK_BW = 450e9  # bytes/s a card, each direction (NVLink 4, 18 links)
HBM_BYTES = 80e9  # bytes of HBM a card
