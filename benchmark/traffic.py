"""The generator: a traffic file's scenario draw and the check's sample
from a seed.

A traffic file (``benchmark/traffic/<name>.json``) states the batch, the
warm-up ticks, the rows and ticks the check samples, the profiled block,
and ``scenarios``: the parameters of its family's draw (ranges of speeds,
curvatures, radii), which the family's reference module turns into
per-row float32 fields with ``draw(scenarios, batch, seed)``. Every seed
gives the same batch and the same work; only the values differ.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The traffic file of ``name``."""
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def seed_of(seed: int) -> int:
    """A non-negative seed for numpy of any whole number."""
    return int(seed) % (1 << 63)


def draw(spec: dict, family: str, seed: int) -> dict:
    """{field: float32 array of ``spec["batch"]`` rows} from the seed, by
    the draw of ``benchmark/reference/<family>.py``."""
    mod = importlib.import_module(f"benchmark.reference.{family}")
    return mod.draw(spec["scenarios"], int(spec["batch"]), seed_of(seed))


def sample(spec: dict, seed: int) -> tuple:
    """(rows, fractions): the rows the check reads, and the points of the
    window, as fractions of it, at whose next tick it records; both drawn
    from the seed, apart from the draw."""
    rng = np.random.default_rng([seed_of(seed), 1])
    c = spec["check"]
    B = int(spec["batch"])
    rows = np.sort(rng.choice(B, size=min(int(c["rows"]), B), replace=False))
    fractions = np.sort(rng.uniform(0.0, 1.0, int(c["window_ticks"])))
    return rows, fractions
