"""The architectures the benchmark serves, one module each, found by the
``model.arch`` name of a configuration's file: ``models/<arch>.py``.  A
configuration whose architecture has no module here is refused before
anything runs.

An architecture module supplies, for ``config`` (the parsed
configuration file) and ``fw`` (the float weights it made):

* ``float_weights(model, seed, device)``: the float weights, from the seed;
* ``input_pool(model, n, seed, device)``: ``n`` distinct inputs, a host
  array whose first axis the traffic slices into requests;
* ``front_door(config, fw, device, telemetry)``: the program's front door
  serving those weights (``submit`` / ``step`` / ``run``,
  ``reset_stats``, ``stats``);
* ``request(rid, rows)``: a front-door request of a slice of the pool,
  whose ``logits`` hold one answer a row once it is ``done``;
* ``reference_logits(config, fw, x, act_qmax=..., w_qmax=...)``: the
  plain reference's answers to ``x``, worked out from ``fw`` alone; the
  two integer ranges set its precision (the control lowers them);
* ``ops_per_row(config)``: the int8 operations of one row's forward;
* ``kernel_launches(config, kernel)``: the ``work.Launch`` es a
  microbatch makes on the kernel of that name, empty where the
  configuration runs none on it.

The program is imported inside these functions, never when the module
is, so that the plain reference and the benchmark's own counts load
nothing of it.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REQUIRED = ("float_weights", "input_pool", "front_door", "request",
            "reference_logits", "ops_per_row", "kernel_launches")


def load(arch: str, root: Path = ROOT):
    """The module of architecture ``arch`` under ``root``'s
    ``portbench/models``; ValueError where there is none or it lacks a
    function of ``REQUIRED``."""
    if not isinstance(arch, str) or not re.fullmatch(r"[A-Za-z0-9_]+",
                                                      arch):
        raise ValueError(f"architecture name {arch!r}: letters, digits "
                         f"and '_' only")
    path = Path(root) / "portbench" / "models" / f"{arch}.py"
    if not path.is_file():
        raise ValueError(f"no module for architecture {arch!r} "
                         f"(portbench/models/{arch}.py)")
    spec = importlib.util.spec_from_file_location(f"portbench_arch_{arch}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in REQUIRED if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"portbench/models/{arch}.py lacks {missing}")
    return mod
