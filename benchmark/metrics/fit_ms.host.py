"""fit_ms.host: ``fit_ms`` (metrics/fit_ms.py) in a cell whose fit time
spreads between runs by more than any bound can hold, so that the cell
reports ``fit_ms`` per layer (``fit_ms.host``) and not end to end."""

from pathlib import Path

import harness


def read(run):
    return harness.load_module(
        Path(__file__).with_name("fit_ms.py")).read(run)
