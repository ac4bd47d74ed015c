"""The work of one MSE ALS fit streamed from a ``.spz`` file: the dense MSE
fit's count (the same iterations on the same matrix: two products with A,
4kmn operations, and two Grams, 2k^2(m + n), an iteration; A read twice and
each factor read and written once) plus one pass over the file's bytes a
fit."""

import os


def count(m: int, n: int, k: int, traffic: dict, result, data=None):
    it = int(result.iterations)
    ops = it * (4 * k * m * n + 2 * k * k * (m + n))
    nbytes = it * (8 * m * n + 8 * k * (m + n)) + os.path.getsize(data)
    return float(ops), float(nbytes)
