"""The general traffic generator: a mix is a JSON file of parameters
(``bench_port/traffic/<mix>.json``), and this module turns it, the seed and
a frame number into that frame's traffic state: the camera's ``eye`` and
``target``, the sun's direction and whether it moved (``sun_moves``). One
client runs a closed loop: the next frame starts when the previous frame's
uint8 image is on the host.

Keys of a mix (besides ``why``):

- ``camera``, one of
  - ``{"path": "orbit", "rad_per_frame": r, "distance": d, "height": h}``:
    the eye circles the origin at horizontal distance d and height h,
    looking at it, turning r radians about +Y a frame from a start angle
    drawn from the seed;
  - ``{"path": "keyframes", "keys": [[eye, target], ...],
    "frames_per_key": n}``: the eye and target move linearly from key to
    key, n frames a key, and loop, from a start frame drawn from the seed
    (with n = 1, a cut to the next key every frame);
- ``sun``: ``{"path": "fixed"}`` (the scene's sun every frame) or
  ``{"path": "sweep", "rad_per_frame": r}``: the sun's direction turns r
  radians about +Y a frame from a phase drawn from the seed.

Every seed draws only where the loop starts, so every seed gives the same
kind and amount of work.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

_CAMERA = {"orbit": ({"path", "rad_per_frame", "distance", "height"}, set()),
           "keyframes": ({"path", "keys", "frames_per_key"}, set())}
_SUN = {"fixed": ({"path"}, set()), "sweep": ({"path", "rad_per_frame"}, set())}


def _check(path, what: str, entry: dict, kinds: dict) -> None:
    kind = entry.get("path")
    if kind not in kinds:
        raise ValueError(f"traffic mix {path}: unknown {what} path {kind!r}; one of {sorted(kinds)}")
    need, may = kinds[kind]
    if not need <= set(entry) <= need | may:
        raise ValueError(f"traffic mix {path}: {what} keys {sorted(entry)}, expected "
                         f"{sorted(need)} and any of {sorted(may)}")


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if set(mix) - {"why"} != {"camera", "sun"}:
        raise ValueError(f"traffic mix {path}: keys {sorted(mix)}, expected camera, sun, why")
    _check(path, "camera", mix["camera"], _CAMERA)
    _check(path, "sun", mix["sun"], _SUN)
    return mix


class Traffic:
    """Frame k's state for one mix and seed: the same seed gives the same
    frames."""

    def __init__(self, mix: dict, seed: int, sun_direction) -> None:
        self.mix = mix
        rng = np.random.default_rng([seed % (2 ** 63), 0x7A11])
        self.start_angle = float(rng.uniform(0.0, 2.0 * math.pi))
        self.sun_phase = float(rng.uniform(0.0, 2.0 * math.pi))
        self.start_frame = int(rng.integers(0, 1 << 20))
        self.sun0 = tuple(float(v) for v in sun_direction)

    def _orbit(self, cam: dict, k: int):
        a = self.start_angle + k * cam["rad_per_frame"]
        d = cam["distance"]
        return (d * math.sin(a), cam["height"], d * math.cos(a)), (0.0, 0.0, 0.0)

    def _keyframes(self, cam: dict, k: int):
        keys = cam["keys"]
        n = cam["frames_per_key"]
        f = (self.start_frame + k) % (n * len(keys))
        i, t = f // n, (f % n) / n
        (e0, t0), (e1, t1) = keys[i], keys[(i + 1) % len(keys)]
        lerp = lambda a, b: tuple(float(x + t * (y - x)) for x, y in zip(a, b))  # noqa: E731
        return lerp(e0, e1), lerp(t0, t1)

    def state(self, k: int) -> dict:
        cam = self.mix["camera"]
        eye, target = (self._orbit if cam["path"] == "orbit" else self._keyframes)(cam, k)
        sun_moves = self.mix["sun"]["path"] == "sweep"
        sun = self.sun0
        if sun_moves:
            a = self.sun_phase + k * self.mix["sun"]["rad_per_frame"]
            c, s = math.cos(a), math.sin(a)
            x, y, z = self.sun0
            sun = (x * c + z * s, y, -x * s + z * c)
        return dict(eye=eye, target=target, sun_direction=sun, sun_moves=sun_moves)
