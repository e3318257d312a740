"""``epoch_ms`` in the host-bound cells: the window's mean epoch where host
dispatch sets the pace (the device idles about a third of each epoch). Its
runs spread with the load on the card's host, several times as far as
those of the device-bound cells, so it carries a bound of its own; a bound
belongs to a metric's name, so a bound of its own takes a name of its own,
and the per-layer metrics of these cells move it under ``.dispatch``
twins of their names."""

import os

from portbench import cells

_BASE = cells.reader(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "epoch_ms")
UNIT, SOURCE, MOVES, LAYER = _BASE.UNIT, _BASE.SOURCE, None, None
read = _BASE.read
