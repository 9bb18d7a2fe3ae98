"""Checkpoints of the port (the counterpart of :mod:`repro.ckpt`)."""
from .checkpoint import latest_step, restore, restore_latest, save, steps

__all__ = ["latest_step", "restore", "restore_latest", "save", "steps"]
