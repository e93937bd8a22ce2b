"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below
the configuration's (int4: activations and weights on 7 levels a sign),
read by the same comparison at a cell's own size and sample.  Its
``logit_gap`` has to exceed the limit on every seed.

    python3 portbench/control.py --workload <name> --seeds 11 12 13

prints one line per seed: the control's ``logit_gap`` against the int8
reference over the rows a run of that seed compares (here the first
``CHECK_ROWS`` images of the seed's pool).  Runs where the cell runs: on
the card at the cell's size.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CONTROL_QMAX = 7           # int4: the precision below int8


def control_gap(config: dict, seed: int, device: str, rows: int,
                root: Path = ROOT) -> tuple:
    """(the control's logit_gap, the sound reference's against itself)
    over ``rows`` inputs of the seed's pool."""
    import torch

    from portbench import bench, models
    arch = models.load(config["model"]["arch"], root)
    m = config["model"]
    fw = arch.float_weights(m, seed, device)
    pool = arch.input_pool(m, max(rows, 1), seed, device)
    x = torch.from_numpy(pool[:rows]).to(device)
    want = arch.reference_logits(config, fw, x).cpu().numpy()
    again = arch.reference_logits(config, fw, x).cpu().numpy()
    low = arch.reference_logits(config, fw, x, act_qmax=CONTROL_QMAX,
                                w_qmax=CONTROL_QMAX).cpu().numpy()
    return bench.compare(low, want), bench.compare(again, want)


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import bench
    spec = bench.load_spec(ROOT)
    _, config, _ = bench.find_cell(spec, args.workload, ROOT)
    limit = config["limits"]["logit_gap"]
    worst = None
    for seed in args.seeds:
        t = time.perf_counter()
        gap, self_gap = control_gap(config, seed, args.device,
                                    bench.CHECK_ROWS)
        worst = gap if worst is None else min(worst, gap)
        print(f"control {args.workload} seed {seed}: logit_gap {gap!r} "
              f"(limit {limit!r}; the reference against itself "
              f"{self_gap!r}) in {time.perf_counter() - t:.1f} s",
              flush=True)
    print(f"control {args.workload}: smallest logit_gap {worst!r} over "
          f"{len(args.seeds)} seeds, limit {limit!r}: "
          f"{'fails the check' if worst > limit else 'PASSES the check'}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
