"""Poisson counts around a background plus planted blocks, at a set share of
nonzeros.

A plain-torch copy of ``chip_smoke.py::stream_counts_i``: factor f owns the
rows and the columns congruent to f mod ``blocks``, at level ``top *
decay^f`` times uniform [0.5, 1.5) row and column weights; the background b
is set by bisection so that the expected share of nonzeros, 1 - exp(-(b +
block)), over every 37th entry is ``density``.  Made on the device from the
seed; returns A (m, n) float32 on ``device``.
"""

import torch


def _bisect_rising(share_of, target, iters=40):
    """s with share_of(s) == target, for share_of rising in s."""
    lo, hi = 0.0, 1.0
    while share_of(hi) < target:
        hi *= 2.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if share_of(mid) < target else (lo, mid)
    return 0.5 * (lo + hi)


def make(config: dict, seed: int, device) -> torch.Tensor:
    m, n, k = int(config["m"]), int(config["n"]), int(config["blocks"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    a = torch.rand(m, device=device, generator=gen) + 0.5
    c = torch.rand(n, device=device, generator=gen) + 0.5
    level = float(config["top"]) * float(config["decay"]) ** torch.arange(
        k, device=device, dtype=torch.float32)
    rf = torch.arange(m, device=device) % k
    cf = torch.arange(n, device=device) % k
    block = torch.where(rf[:, None] == cf[None, :],
                        (level[rf] * a)[:, None] * c[None, :],
                        torch.zeros((), device=device))
    sample = block.flatten()[::37]
    b = _bisect_rising(
        lambda s: float((1.0 - torch.exp(-(s + sample))).mean()),
        float(config["density"]))
    block += b
    return torch.poisson(block, generator=gen)
