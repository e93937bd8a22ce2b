"""Graph units and ops: device kernel launches in the traced window over
the images answered in it."""


def read(rec):
    dt = rec["device_trace"]
    if dt is None or not rec["images_done"]:
        return None
    return dt["launches"] / rec["images_done"]
