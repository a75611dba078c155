"""device_idle_pct.card: ``device_idle_pct.selfplay``'s reading, in a cell
whose end-to-end metric besides set-up is ``selfplay_card_us_per_search``.
Moves ``selfplay_card_us_per_search``."""

import os

from benchmark import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
read = spec.metric_reader("device_idle_pct.selfplay", ROOT)
