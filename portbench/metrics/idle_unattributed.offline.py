"""Card: the share of the window with the card idle and no program span
open (`spans.idle_under_spans`), in a closed loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    idle = spans.idle_under_spans(rec)
    if idle is None:
        return None
    return 100.0 * idle.get("", 0.0) / rec["window_s"]
