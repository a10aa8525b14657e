"""What ``calibrate.py`` needs of a loop, one module a loop, found by the
loop's name (``calibration/<loop>.py``, as ``loops/<loop>.py`` is):

- ``faults(mix)``: fault name → a factory whose context plants that fault
  underneath the loop's timed path, for the faults a cell of this mix can
  have;
- ``WINDOW``: whether the loop's outputs come out of a measured window (a
  calibration run then runs one, and a fault's run is judged by its own
  inputs' truth, since each window serves other requests);
- ``as_outputs(result)``: the loop's outputs from what the loop's
  ``reference`` returns, so the reference can stand in the program's place;
- ``numbers(outputs, truth)``: the numbers a run is judged by, with any
  extra readings for the look at a seed that reads far from the others."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)
