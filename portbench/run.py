"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m portbench.run ...`` from the checkout's root).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the checks are also the last lines of standard error.

The run exits with another code than 0, and prints no result, where
there is no CUDA device or fewer than the cell asks for, where the
program is not beside the benchmark, and where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has
closed.  Every build and kernel cache stays inside the checkout.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _paths():
    """The checkout's root (for ``portbench``) and its ``src`` (for the
    program) on the import path; the caches inside the checkout."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(SRC), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    if not (SRC / "repro_torch").is_dir():
        return fail(f"the program (src/repro_torch) is not beside the "
                    f"benchmark in {ROOT}")
    import torch
    from portbench import bench
    spec = bench.load_spec(ROOT)
    cell = next((c for c in spec["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} CUDA devices, "
                    f"{torch.cuda.device_count()} present")
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, _ = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_process=T_PROCESS, spec=spec)
    found = bench.forbidden_modules()
    if found:
        return fail(f"modules of JAX or of the JAX package are loaded: "
                    f"{found}")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
