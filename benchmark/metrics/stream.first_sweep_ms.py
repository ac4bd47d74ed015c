"""stream.first_sweep_ms: host clock from the call into ``nmf`` to the
streaming engine's first ``on_iteration`` callback (decode, upload and the
first panel solves), the mean over the window's fits, in ms."""


def read(run):
    firsts = [f.sweep_marks[0] for f in run.fits if f.sweep_marks]
    return sum(firsts) / len(firsts) * 1e3 if firsts else None
