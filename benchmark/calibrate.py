"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size: for each seed the program's numbers against the plain
reference, and on the ``--extra`` seeds also the control's (the reference
one precision below the configuration's, put in the program's place) and,
for a train cell, the half-batch fault's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--extra 1,2,3]

A view cell renders as many frames as a run's check samples; a train cell
takes its first steps in set-up, as a run does. One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--extra", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import cache_env

    cache_env(ROOT)
    import torch

    from benchmark.harness import spec as S

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = S.load_cell(args.workload, ROOT)
    drv = S.driver(cell.workload["driver"])
    extra = {int(s) for s in args.extra.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sut = drv.build(cell.config, cell.workload["traffic"], seed, "cuda")
        if sut.kind == "view":
            n = int(cell.workload["traffic"]["sample_frames"])
            readings = sut.check([sut.to_host(sut.frame()) for _ in range(n)], seed in extra)
        else:
            readings = sut.check([], seed in extra)
        del sut
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
