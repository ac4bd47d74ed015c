"""fit_p95_ms: the 95th percentile of every window fit's wall time on the
host clock (each fit ending in ``torch.cuda.synchronize()``), in ms."""

import numpy as np


def read(run):
    if not run.fits:
        return None
    return float(np.percentile([f.wall_s for f in run.fits], 95)) * 1e3
