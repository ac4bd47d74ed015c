"""The matrix as it is made: a dense float32 tensor on the fit's device."""


def prepare(A, traffic: dict, workdir: str):
    """Returns (the data handed to ``nmf``, whether the benchmark keeps A
    for the reference)."""
    return A, True
