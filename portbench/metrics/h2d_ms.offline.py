"""Engine: the mean `h2d` span of the window (a microbatch's copy to the
card, the host blocked until it lands), in ms, in a closed loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    return spans.mean_ms(rec, "h2d")
