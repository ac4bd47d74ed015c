"""The work of one dense MSE ALS fit, counted from shapes for what the
algorithm needs, whatever implements it.

An iteration: the two products with A (W^T A and H A^T) take 4kmn
operations, the two Grams 2k^2(m + n); A is read twice (2 * 4mn bytes) and
each factor read and written once (2 * 4k(m + n) bytes).
"""


def count(m: int, n: int, k: int, traffic: dict, result, data=None):
    """(operations, bytes) of the fit that produced ``result``."""
    it = int(result.iterations)
    ops = it * (4 * k * m * n + 2 * k * k * (m + n))
    nbytes = it * (8 * m * n + 8 * k * (m + n))
    return float(ops), float(nbytes)
