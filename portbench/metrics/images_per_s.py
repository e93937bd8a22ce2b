"""Images whose logits came back in a closed loop's window, over the
window's seconds (the window closes at the end of the first step that
ends past its length)."""


def read(rec):
    if rec["loop"] != "closed":
        return None
    return rec["images_done"] / rec["window_s"]
