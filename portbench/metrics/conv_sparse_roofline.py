"""Kernels: the least time of the traced window's launches of
``conv_sparse`` over their device time (``conv_mma_kernel<true, ...>``).
The least time is, per launch, the larger of its operations over the int8
peak and its bytes over HBM bandwidth (``work.least_s``), for the
launches the architecture counts on ``conv_sparse``
(``kernel_launches``), at the microbatch sizes of the window's
``stage0`` spans.  Nothing to read where the configuration runs no
launch on it."""

import re

from portbench import work

KERNEL = "conv_sparse"
NAME = re.compile(r"conv_mma_kernel<\s*true\b")


def read(rec):
    dt = rec["device_trace"]
    if dt is None or not rec["microbatch_rows"]:
        return None
    launches = rec["arch"].kernel_launches(rec["config"], KERNEL)
    t = sum(v for k, v in dt["by_name"].items() if NAME.search(k))
    if not launches or t <= 0:
        return None
    return 100.0 * work.least_s(launches, rec["microbatch_rows"]) / t
