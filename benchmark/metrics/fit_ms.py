"""fit_ms: the measured window over the fits completed in it (closed loop,
one caller, each fit ending in a host read of its result), in ms."""


def read(run):
    return run.window_s / len(run.fits) * 1e3 if run.fits else None
