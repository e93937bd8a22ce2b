"""The whole step's share of the card's int8 peak: images answered in the
window times the configuration's int8 operations an image (2 x the kept
weights' MACs, the architecture's ``ops_per_row``), over the window
times 1,979 TOP/s."""

from portbench import peaks


def read(rec):
    if not rec["images_done"]:
        return None
    ops = rec["arch"].ops_per_row(rec["config"])
    return (100.0 * rec["images_done"] * ops
            / (rec["window_s"] * peaks.PEAK_INT8))
