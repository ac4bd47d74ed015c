"""fit_mfu: the fit's operations (``work/<traffic's work>.py``) over the
wall time per fit of the window's fits times the peak rate (``peaks.json``),
in %.  The wall time comes from fits timed outside the profiler."""


def read(run):
    if not run.fits or run.work is None:
        return None
    per_fit_s = run.window_s / len(run.fits)
    return 100.0 * run.work[0] / (per_fit_s * run.peaks["flops_per_s"])
