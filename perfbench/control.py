"""The control of a cell's comparison, and the program's readings beside it.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed, one run of the cell (as run.py, a short window), then the
numbers the comparison reads twice: of the program's answers, and of the
control's, the plain reference computed in the precision below the one the
configuration states (its "control": TF32 for float32 with TF32 off,
bfloat16 for other float32) and put in the program's place for the same
requests. Prints one JSON line a seed; the control has to fail. Not run by
the benchmark's own runs.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.pin_caches()
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    t_start = T_START
    for seed in args.seeds.split(","):
        out = harness.run_cell(args.workload, int(seed), args.seconds, False,
                               torch.device("cuda", 0), t_start,
                               control=True)
        failed = [n for n, c in out["control"].items()
                  if c["value"] > c["limit"]]
        print(json.dumps({"workload": args.workload, "seed": int(seed),
                          "correct": out["correct"],
                          "program": out["checks"],
                          "control": out["control"],
                          "control_fails": failed,
                          "metrics": out["metrics"]}), flush=True)
        t_start = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
