"""Front door: the mean `validate` span of the window (the door's check of
one request's images, `np.isfinite` over every pixel), in ms, in a closed
loop."""

from portbench import spans


def read(rec):
    if rec["loop"] != "closed":
        return None
    return spans.mean_ms(rec, "validate")
