"""setup_s: process start to the first timed fit: imports, the kernels'
build or load, the data made on the card, the input written, one warm-up
fit."""


def read(run):
    return run.setup_s
