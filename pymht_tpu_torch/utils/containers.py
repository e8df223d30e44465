"""Small host-side value types mirroring the reference's container
classes (the reference pyMHT's pymht/utils/classDefinitions.py:241-338):
``Position`` and ``Velocity`` with arithmetic, comparison and plotting
conveniences (the port's own copy of pymht_tpu/utils/containers.py).
Device code never uses these — they exist for API parity
and host-side scripting ergonomics.
"""
from __future__ import annotations

import numpy as np


class _Vec2:
    __slots__ = ("array",)

    def __init__(self, *args):
        # accepts (x, y), ([x, y],), (Position,), (np.ndarray,)
        if len(args) == 1:
            a = args[0]
            if isinstance(a, _Vec2):
                a = a.array
            self.array = np.asarray(a, dtype=np.float64).reshape(2)
        elif len(args) == 2:
            self.array = np.array([float(args[0]), float(args[1])])
        else:
            raise TypeError(f"{type(self).__name__} takes 1 or 2 arguments")

    @property
    def x(self):
        return float(self.array[0])

    @property
    def y(self):
        return float(self.array[1])

    def __getitem__(self, i):
        return float(self.array[i])

    def __iter__(self):
        return iter((self.x, self.y))

    def __add__(self, other):
        return type(self)(self.array + _as_array(other))

    def __sub__(self, other):
        return type(self)(self.array - _as_array(other))

    def __mul__(self, k):
        return type(self)(self.array * float(k))

    __rmul__ = __mul__

    def __truediv__(self, k):
        return type(self)(self.array / float(k))

    def __eq__(self, other):
        try:
            return bool(np.allclose(self.array, _as_array(other)))
        except Exception:
            return NotImplemented

    def __hash__(self):
        return hash(tuple(np.round(self.array, 9)))

    def norm(self):
        return float(np.linalg.norm(self.array))

    def to_array(self):
        return self.array.copy()

    def __repr__(self):
        return (f"{type(self).__name__}({self.array[0]:.6g},"
                f" {self.array[1]:.6g})")


def _as_array(v):
    if isinstance(v, _Vec2):
        return v.array
    return np.asarray(v, dtype=np.float64).reshape(2)


class Position(_Vec2):
    """2D east/north position (reference classDefinitions.py:241-301)."""

    def distance_to(self, other):
        return float(np.linalg.norm(self.array - _as_array(other)))

    def in_range_of(self, center, radius):
        return self.distance_to(center) <= float(radius)

    def plot(self, ax=None, **kw):
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        ax.plot([self.x], [self.y], marker=kw.pop('marker', 'o'), **kw)


class Velocity(_Vec2):
    """2D velocity (reference classDefinitions.py:304-338)."""

    def speed(self):
        return self.norm()

    def heading_deg(self):
        return float((np.degrees(np.arctan2(self.x, self.y)) + 360.0)
                     % 360.0)
