"""Card: the share of the traced window with no kernel or copy running
(torch.profiler), in a closed loop."""


def read(rec):
    dt = rec["device_trace"]
    if rec["loop"] != "closed" or dt is None:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / rec["window_s"])
