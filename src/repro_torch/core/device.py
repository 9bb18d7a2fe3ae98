"""Devices and random streams of the PyTorch port.

``resolve_device`` gives every entry point its device: ``None`` means the
card, and a missing card is an error, never a silent run on the CPU.

Random numbers come from ``torch.Generator``s.  Where the JAX package
splits or folds a PRNG key, the port derives a child seed with
:func:`derive_seed` (numpy's ``SeedSequence``), so every stage of a fit
draws from its own stream, deterministically from the caller's seed.  The
streams are not JAX's threefry streams and do not try to be.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: "torch.device | str | None" = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.  Raises
    ``RuntimeError`` for CUDA when no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev


def seed_of(seed: "int | torch.Generator") -> int:
    """An integer seed: ``seed`` itself, or one drawn from a generator."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=seed,
                                 device=seed.device).item())
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return int(seed)


def derive_seed(seed: int, *path: int) -> int:
    """The seed of child stream ``path`` of ``seed`` (the counterpart of
    ``jax.random.split`` / ``fold_in``)."""
    ss = np.random.SeedSequence([int(seed), *map(int, path)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_generator(seed: "int | torch.Generator",
                   device: torch.device) -> torch.Generator:
    """A generator on ``device``: the caller's own when it already lives
    there, else a fresh one seeded from ``seed``."""
    if isinstance(seed, torch.Generator) and seed.device.type == device.type:
        return seed
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed))
    return g
