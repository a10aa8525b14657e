"""Host-side Vecchia preprocessing: the maximin ordering and the nearest and
scaled-ball predecessor sets, in C++ (``vecchia_order.cpp``, built with g++
at first use and loaded with ctypes) with numpy versions where no compiler
is found."""

from .ordering import (
    maximin_ordering,
    native_available,
    nearest_predecessor_neighbors,
    scaled_ball_predecessors,
)

__all__ = [
    "maximin_ordering",
    "nearest_predecessor_neighbors",
    "native_available",
    "scaled_ball_predecessors",
]
