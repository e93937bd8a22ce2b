"""Engine: the window's ``frontend.step()`` time over its steps, on the
benchmark's clock, in a closed loop."""


def read(rec):
    if rec["loop"] != "closed" or not rec["step_s"]:
        return None
    return 1e3 * sum(rec["step_s"]) / len(rec["step_s"])
