"""``vgg.roofline`` in the host-bound cells. Their epoch swings with the load on
the card's host and is read per layer (``epoch_ms.host_bound``), so
this twin moves the end-to-end metric they keep, ``peak_mem_mib``."""

import os

from portbench import cells

_BASE = cells.reader(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "vgg.roofline")
UNIT, SOURCE, LAYER = _BASE.UNIT, _BASE.SOURCE, _BASE.LAYER
MOVES = "peak_mem_mib"
read = _BASE.read
