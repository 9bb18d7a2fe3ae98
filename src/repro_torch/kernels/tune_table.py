"""Committed per-card launch configs — the autotuner's layer-3 fallback
(:func:`repro_torch.kernels.autotune.lookup`).

``TABLE[kernel][card pattern][shape bucket]`` holds ``TileConfig`` fields
(``autotune.shape_bucket`` names the buckets; ``"*"`` matches any).  A
card matches a pattern when the pattern's lowercase form appears in the
lowercase CUDA device name; patterns are tried in order and ``"*"``, the
derived plan (every axis 0, the formulas of ``tiles.py``), comes last.  A
pattern without the bucket falls through to the next, so a card or a shape
with no row runs the derived plan.

A card's rows come only from a sweep on that card
(``python -m repro_torch.kernels.autotune --sweep``); each row is the
sweep's suggestion (``autotune.suggest_rows``): a config that beat the
derived plan by more than the run-to-run spread at every swept shape of
its bucket.  A kernel without such a config has no row for the card.
"""
from __future__ import annotations

from typing import Optional

# {kernel: {card pattern: {shape bucket: TileConfig fields}}}
#
# "H100 80GB HBM3" rows: the suggestions of one
# `python -m repro_torch.kernels.autotune --sweep` on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit that held at the paths' own shapes of
# their buckets (PERF.md section 6, the tuning table); beside each, the
# swept shape and its ms per launch, derived plan -> row.  Every other
# bucket keeps the derived plan, scan B128_L2048_m64_C256 among them
# (blocks 2 won on random tables, not on the search's own).  Rows are kept
# only where a path looks them up: cuda_tuned's Lloyd steps and
# assignments and the ADC scan.
H100 = "H100 80GB HBM3"
TABLE: dict = {
    "lloyd": {
        H100: {
            # index_200k's coarse merge (4, 6554, 256, 64): every center
            # resident, 0.1394 -> 0.1320
            "B4_M8192_d64_K256": {"center_tile": 256},
            # chunked_dist_50m's fold, a full wave of blocks where the
            # formula evens the tiles out: (8, 131072, 256, 8) 0.3438 ->
            # 0.3184 at 99 blocks, (8, 89616, 175, 8) 0.1833 -> 0.1726;
            # moves the last bits of the sums
            "B8_M131072_d8_K256": {"blocks": 128},
        },
        "*": {"*": {}},
    },
    "assign": {
        H100: {
            # oocore_5m's predict (1, 262144, 64, 8): one point a thread,
            # 0.03424 -> 0.02179
            "B1_M262144_d8_K64": {"points": 1},
        },
        "*": {"*": {}},
    },
    # no path looks the centroid kernel up (cuda_tuned's step is fused)
    "centroid": {"*": {"*": {}}},
    "scan": {"*": {"*": {}}},
}


def load_default(kernel: str, device_kind: str,
                 bucket: str = "*") -> "Optional[object]":
    """The first matching :class:`~repro_torch.kernels.autotune.TileConfig`
    for a card and shape bucket, or ``None`` when no row matches (the
    caller then uses the derived plan)."""
    from .autotune import TileConfig
    needle = device_kind.lower()
    for pattern, buckets in TABLE.get(kernel, {}).items():
        if pattern == "*" or pattern.lower() in needle:
            fields = buckets.get(bucket, buckets.get("*"))
            if fields is not None:
                return TileConfig.from_dict(fields)
    return None


def validate_table() -> int:
    """Check every row: a known kernel, bucket names of the kernel's form,
    fields only of the kernel's axes, a last ``"*"`` pattern whose ``"*"``
    bucket is the derived plan.  Returns the entry count; raises
    ``ValueError`` on anything else (the ``--check-defaults`` contract)."""
    from .autotune import AXES, BUCKET_RE, KERNELS, TileConfig
    n = 0
    for kernel, rows in TABLE.items():
        if kernel not in KERNELS:
            raise ValueError(f"tune_table: unknown kernel {kernel!r}; "
                             f"known: {KERNELS}")
        if not isinstance(rows, dict) or list(rows)[-1:] != ["*"]:
            raise ValueError(f"tune_table[{kernel!r}]: the card patterns "
                             f"must end with '*'")
        if rows["*"].get("*") != {}:
            raise ValueError(f"tune_table[{kernel!r}]['*']: its '*' bucket "
                             f"must be the derived plan ({{}})")
        for pattern, buckets in rows.items():
            if not isinstance(buckets, dict) or not buckets:
                raise ValueError(f"tune_table[{kernel!r}][{pattern!r}]: must "
                                 f"be a non-empty dict of shape buckets")
            for bucket, fields in buckets.items():
                where = f"tune_table[{kernel!r}][{pattern!r}][{bucket!r}]"
                if bucket != "*" and not BUCKET_RE[kernel].match(bucket):
                    raise ValueError(f"{where}: not a {kernel} bucket")
                cfg = TileConfig.from_dict(fields)
                extra = [a for a in cfg._fields
                         if getattr(cfg, a) and a not in AXES[kernel]]
                if extra:
                    raise ValueError(f"{where}: {kernel} takes no {extra}")
                n += 1
    return n
