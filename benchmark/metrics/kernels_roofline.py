"""kernels_roofline: the fit's least time on the chip over the summed device
time of every kernel, copy and memset of a traced fit, in %.

The least time is the larger of the fit's operations over the peak rate and
its bytes over the memory rate (``peaks.json``), the work counted from
shapes (``work/<traffic's work>.py``)."""


def read(run):
    t = run.trace
    if t is None or not t.device_s or run.work is None:
        return None
    ops, nbytes = run.work
    least = max(ops / run.peaks["flops_per_s"],
                nbytes / run.peaks["bytes_per_s"])
    return 100.0 * least / (t.device_s / t.fits)
