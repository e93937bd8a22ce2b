"""The work of a forward's kernel launches and the least time the card
could take for it.  Each architecture module (``models/<arch>.py``)
counts its launches from its network's shapes as ``Launch`` es; the
counts are the benchmark's own, so they read the same work whatever
implements it.
"""
from __future__ import annotations

import dataclasses

from portbench import peaks


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch a microbatch makes: its kept-weight MACs and the
    bytes it moves per row, and the bytes it moves once (weights, bias)."""

    name: str
    macs: int              # kept-weight MACs per row
    act_bytes: int         # bytes per row: input, output, shortcut, rows
    weight_bytes: int      # bytes per launch: weights and bias


def least_s(launches: list, microbatch_rows) -> float:
    """The least time the card could take for ``launches`` in each
    microbatch of the given row counts: per launch, the larger of its
    int8 operations (2 x MACs) over the int8 peak and its bytes over HBM
    bandwidth."""
    total = 0.0
    for n in microbatch_rows:
        for c in launches:
            total += max(2 * c.macs * n / peaks.PEAK_INT8,
                         (c.act_bytes * n + c.weight_bytes) / peaks.HBM_BW)
    return total
