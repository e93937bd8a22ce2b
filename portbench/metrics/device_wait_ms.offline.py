"""Engine: the mean `wait` span of the window (the host blocked on the
card in the logits' `out.cpu()`), in ms, in a closed loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    return spans.mean_ms(rec, "wait")
