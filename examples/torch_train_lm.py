"""End-to-end LM training on the PyTorch port: train -> crash -> resume ->
QAT finetune (ports ``examples/train_lm.py``).

Trains a reduced model on the synthetic Markov stream, crashes on purpose
at 60 % of the steps, resumes from the latest checkpoint, then finetunes
with INT7 fake-quant (QAT) so the weights compile into the
constant-parameter serving form.  On the card every attention layer runs
the flash-attention kernel forward (twice per step under the layer remat)
and its backward kernel once per step.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
      [--arch ...] [--device cpu]
(``--preset full --seq 512`` trains the published widths on the card.)
"""
import argparse
import math
import pathlib
import shutil
import tempfile

from repro_torch.launch import train as trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the first card) or 'cpu'")
    args = ap.parse_args(argv)

    ckpt = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    common = ["--arch", args.arch, "--preset", args.preset,
              "--seq", str(args.seq), "--batch", str(args.batch),
              "--ckpt-dir", str(ckpt), "--ckpt-every", "50",
              "--device", args.device]
    try:
        print("=== phase 1: train (will crash at 60%) ===")
        try:
            trainer.main(common + ["--steps", str(args.steps),
                                   "--fail-at-step",
                                   str(int(args.steps * 0.6))])
            crashed = None
        except SystemExit as e:
            crashed = e.code
            print(f"(crashed as planned: exit {e.code})")
        assert crashed == 42, f"phase 1 exited with {crashed}, want 42"

        print("=== phase 2: resume from latest checkpoint ===")
        resumed = trainer.main(common + ["--steps", str(args.steps),
                                         "--resume"])

        print("=== phase 3: short QAT finetune (INT7 fake-quant forward) ===")
        metrics = trainer.main(common + ["--steps", str(args.steps + 40),
                                         "--resume", "--qat"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert math.isfinite(resumed["ce"]) and math.isfinite(metrics["ce"])
    print(f"final ce={metrics['ce']:.4f}")
    print("train_lm OK")
    return dict(resumed=resumed, qat=metrics)


if __name__ == "__main__":
    main()
