"""The 90th percentile of the walls of every solve in the window, in ms
(linear interpolation between order statistics)."""

import numpy as np


def read(record):
    if not record.walls:
        return None
    return 1e3 * float(np.percentile(record.walls, 90))
