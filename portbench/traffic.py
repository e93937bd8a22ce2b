"""The one traffic generator: it reads a mix file (``traffic/<mix>.json``)
and turns it, with the seed, into the requests a run sends.

Two loops, as the mix's ``loop`` says:

* ``closed``: ``clients`` callers, each keeping one request of
  ``request_images`` outstanding and sending the next when it returns.
  Each request is a contiguous slice of the image pool at an offset
  drawn from the seed.
* ``open``: requests due on a schedule whatever the server is doing
  (``arrivals: "poisson"`` at ``rate_rps``), sizes from ``size_mix``
  (pairs of rows and weight), each a pool slice at a seeded offset.

The open plan follows the program's ``serving/loadgen.py::poisson_plan``
(seeded exponential gaps, a size mix, pool slices), with one change: the
gaps are the exponential distribution's quantiles at ``(i + 0.5) / n``
and the sizes the mix's exact shares, shuffled by the seed, and the gaps
are scaled so that the last request is due at the window's end.  So
every seed sends the same number of requests, the same sizes and the
same set of gaps in another order, and a seed changes which images
arrive when, not how much work there is.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LOOPS = ("closed", "open")


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"{path}: loop must be one of {LOOPS}")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent seeded streams: 0 closed-loop offsets, 1 the open
    plan, 2 the correctness sample."""
    return np.random.default_rng([int(seed), stream])


class ClosedLoop:
    """The offsets of a closed loop's requests, in the order sent."""

    def __init__(self, mix: dict, seed: int, pool_images: int):
        self.rows = int(mix["request_images"])
        self.clients = int(mix["clients"])
        if not 1 <= self.rows <= pool_images:
            raise ValueError(f"request_images {self.rows} outside the "
                             f"pool of {pool_images}")
        self._rng = rng(seed, 0)
        self._hi = pool_images - self.rows + 1

    def next_offset(self) -> int:
        return int(self._rng.integers(0, self._hi))


def open_plan(mix: dict, seed: int, seconds: float,
              pool_images: int) -> list:
    """[(due seconds from the window's start, pool offset, rows)], due
    times ascending, the last at ``seconds``."""
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"arrivals {mix.get('arrivals')!r}: the "
                         f"generator knows 'poisson'")
    rate = float(mix["rate_rps"])
    n = max(1, int(round(rate * seconds)))
    g = rng(seed, 1)
    quant = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-quant) / rate
    gaps = gaps[g.permutation(n)]
    gaps *= seconds / gaps.sum()
    due = np.cumsum(gaps)
    mix_rows = [(int(r), float(w)) for r, w in mix.get("size_mix", [[1, 1]])]
    weights = np.array([w for _, w in mix_rows])
    counts = np.floor(weights / weights.sum() * n).astype(int)
    counts[np.argsort(-weights)[:n - counts.sum()]] += 1
    sizes = np.repeat([r for r, _ in mix_rows], counts)[g.permutation(n)]
    if sizes.max() > pool_images:
        raise ValueError(f"a request of {sizes.max()} rows exceeds the "
                         f"pool of {pool_images}")
    offsets = g.integers(0, pool_images - sizes + 1)
    return [(float(t), int(o), int(r))
            for t, o, r in zip(due, offsets, sizes)]
