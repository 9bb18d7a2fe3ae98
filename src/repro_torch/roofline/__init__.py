"""Roofline accounting for the PyTorch port on the NVIDIA H100.

See :mod:`repro_torch.roofline.analysis`: the card's roofs, a step's
compute, memory and collective terms, and the analytic models (work and
bounds) of the five hand-written kernels.
"""
from .analysis import (DEVICE_ROOFS, PartCost, device_roof, dominant_term,
                       issue_floor_ms, kernel_bound_ms, kernel_cost,
                       kernel_dims, model_flops, pair_bound_ms,
                       predicted_vs_measured, ring_bytes, roofline_terms,
                       tc_lo_blocks)

__all__ = [
    "DEVICE_ROOFS", "PartCost", "device_roof", "dominant_term",
    "issue_floor_ms", "kernel_bound_ms", "kernel_cost", "kernel_dims",
    "model_flops", "pair_bound_ms", "predicted_vs_measured", "ring_bytes",
    "roofline_terms", "tc_lo_blocks",
]
