"""stream.sweep_ms: the mean time between the streaming engine's later
``on_iteration`` callbacks (the sweeps over the cached panels), over the
window's fits, in ms."""


def read(run):
    gaps = [b - a for f in run.fits
            for a, b in zip(f.sweep_marks[:-1], f.sweep_marks[1:])]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
