"""Compile: the `compile` spans of the run (the front door's
`ensure_compiled` of the weights), in s."""


def read(rec):
    tr = rec.get("trace")
    found = [s.dur for s in tr.spans if s.name == "compile"] if tr else []
    if not found:
        return None
    return sum(found) / 1e6
