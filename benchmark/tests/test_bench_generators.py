"""The data generators repeat per seed and hit their configurations' shares
of zeros (at reduced shapes: the share is set by bisection, whatever the
size)."""

import json

import pytest
import torch

import harness
from conftest import BENCH


def config(name, **shape):
    return dict(json.loads((BENCH / "configs" / f"{name}.json").read_text()),
                **shape)


CASES = [("pbmc3k", dict(m=2000, n=600)), ("hcabm40k", dict(m=500, n=4000))]


@pytest.mark.parametrize("name,shape", CASES)
def test_same_seed_same_matrix(name, shape):
    cfg = config(name, **shape)
    gen = harness.load_module(BENCH / "generators"
                              / f"{cfg['generator']}.py")
    a, b = gen.make(cfg, 2**31 + 11, "cpu"), gen.make(cfg, 2**31 + 11, "cpu")
    c = gen.make(cfg, 2**31 + 12, "cpu")
    assert a.shape == (shape["m"], shape["n"]) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("name,shape", CASES)
def test_share_of_zeros(name, shape):
    cfg = config(name, **shape)
    gen = harness.load_module(BENCH / "generators"
                              / f"{cfg['generator']}.py")
    A = gen.make(cfg, 7, "cpu")
    zeros = float((A == 0).double().mean())
    target = cfg["zero_share"] if "zero_share" in cfg \
        else 1.0 - cfg["density"]
    assert abs(zeros - target) < 0.005
    assert bool((A >= 0).all()) and bool((A == A.round()).all())
