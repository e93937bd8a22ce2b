"""Set-up: process start to the first timed request (loading, weights,
the compile, the warm-up, and in a checkout's first run the kernels'
build)."""


def read(rec):
    return rec["setup_s"]
