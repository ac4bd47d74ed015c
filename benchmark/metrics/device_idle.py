"""device_idle: the share of the traced fits' span in which no kernel, copy
or memset ran on the device, in %."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
