"""Poisson counts around a seeded nonnegative low-rank mean, scaled so that
the expected share of zeros is the configuration's ``zero_share``.

A plain-torch copy of ``chip_smoke.py::pbmc_counts`` (Poisson case), made on
the device from the seed in a few large calls: W (m, r) and H (r, n) uniform
[0, 1) with a share ``factor_sparsity`` of their entries zeroed, mean = W H
in float64, and the scale s found by bisection so that the mean of
exp(-s * mean) over every 37th entry is ``zero_share``.  Returns A (m, n)
float32 on ``device``.
"""

import torch


def _bisect_falling(share_of, target, iters=50):
    """s with share_of(s) == target, for share_of falling in s."""
    lo, hi = 0.0, 1.0
    while share_of(hi) > target:
        hi *= 2.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if share_of(mid) > target else (lo, mid)
    return 0.5 * (lo + hi)


def make(config: dict, seed: int, device) -> torch.Tensor:
    m, n, r = int(config["m"]), int(config["n"]), int(config["planted_rank"])
    sparsity = float(config["factor_sparsity"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    f64 = torch.float64
    W = torch.rand((m, r), generator=gen, device=device, dtype=f64)
    W = W * (torch.rand((m, r), generator=gen, device=device) >= sparsity)
    H = torch.rand((r, n), generator=gen, device=device, dtype=f64)
    H = H * (torch.rand((r, n), generator=gen, device=device) >= sparsity)
    mean = W @ H
    sample = mean.flatten()[::37]
    scale = _bisect_falling(
        lambda s: float(torch.exp(-s * sample).mean()),
        float(config["zero_share"]))
    mean *= scale
    return torch.poisson(mean, generator=gen).to(torch.float32)
