"""launches_per_fit: device kernels, copies and memsets per fit, counted in
the profiler's trace over the traced fits."""


def read(run):
    t = run.trace
    return t.launches / t.fits if t is not None and t.launches else None
