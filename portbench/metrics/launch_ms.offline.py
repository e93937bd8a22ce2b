"""Graph units and ops: the mean `stage0` span of the window (the host
enqueueing one microbatch's launches on stage 0), in ms, in a closed
loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    return spans.mean_ms(rec, "stage0", "pipeline")
