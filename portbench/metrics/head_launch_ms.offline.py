"""Graph units and ops: the mean `head` unit span of the window (the host
enqueueing the head pool's and the head's launches), in ms, in a closed
loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    return spans.mean_ms(rec, "head", "unit")
