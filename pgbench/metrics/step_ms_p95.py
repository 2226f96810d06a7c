"""The 95th percentile of every step's host milliseconds in the window
(linear interpolation between ranks)."""

import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec["step_s"]) * 1e3, 95))
