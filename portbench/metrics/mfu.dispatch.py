"""``mfu`` in the host-bound cells, where it moves ``epoch_ms.dispatch``."""

import os

from portbench import cells

_BASE = cells.reader(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "mfu")
UNIT, SOURCE, LAYER = _BASE.UNIT, _BASE.SOURCE, _BASE.LAYER
MOVES = "epoch_ms.dispatch"
read = _BASE.read
