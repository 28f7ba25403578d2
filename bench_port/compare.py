"""How ``correct`` is decided: each checked frame of the timed path against
the plain reference's frame of the same traffic state, as uint8 RGBA.

Two numbers are compared, each the worst over the checked frames, each
with its limit (``LIMITS``; PERF.md gives the readings each was set
from):

- ``px_off``: the share of pixels with any channel more than 1 level
  from the reference's;
- ``mean_abs``: the mean absolute difference over every channel value,
  in levels.

A frame with the wrong extent or type is a failed frame, not a number.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"px_off": 1e-3, "mean_abs": 1e-2}


def numbers(got: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    m = d.max(axis=-1)
    return dict(px_off=float((m > 1).mean()), mean_abs=float(d.mean()),
                px_any=float((m > 0).mean()), px_off8=float((m > 8).mean()), max=int(m.max()))


def well_formed(img, width: int, height: int) -> bool:
    return (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.shape == (height, width, 4))


def judge(readings: list) -> tuple[bool, dict]:
    """(every compared number within its limit, the check line: each
    compared number's worst reading beside its limit)."""
    check = {}
    ok = bool(readings)
    for name, limit in LIMITS.items():
        worst = max((r[name] for r in readings), default=float("nan"))
        check[name] = {"value": worst, "limit": limit}
        ok = ok and worst <= limit
    check["frames"] = {"value": len(readings), "limit": "at least 1"}
    return ok, check
