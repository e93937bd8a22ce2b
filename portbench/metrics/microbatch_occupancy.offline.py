"""Engine: the share of microbatch rows filled over the window
(``PipelineEngine.stats()["microbatch_occupancy"]`` after ``reset_stats``
at the window's start), in a closed loop."""


def read(rec):
    if rec["loop"] != "closed":
        return None
    return rec["occupancy"]
