"""Engine: the mean `pack` span of the window (rows packed into one
microbatch, `np.concatenate` where they come from several requests), in
ms, in a closed loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    return spans.mean_ms(rec, "pack")
