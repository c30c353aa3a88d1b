"""JSONL → TensorBoard exporter — the port's own copy of
tgtc/tools/jsonl2tb.py.

The reference logs training scalars to tensorboardX; the port logs JSONL
(:class:`tgtc_torch.utils.logging.MetricsLogger`: ``nerf.jsonl``,
``transformer.jsonl``, ``temporal.jsonl``, ``vae.jsonl``, ``style.jsonl``
and the pipeline's ``train.jsonl`` under ``<exp_dir>/logs``). Point this
tool at a log directory and it writes TensorBoard event files: one run per
``*.jsonl`` stream, one scalar tag per metric key.

Usage::

    python -m tgtc_torch.tools.jsonl2tb <logdir> [--out <logdir>/tb] [--watch N]

``--watch N`` exports again every N seconds (live dashboards during a run);
each export is incremental (a run appends only the lines past the offset
its last export reached).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict


def export_dir(logdir: str, out: str) -> Dict[str, int]:
    """Export every ``*.jsonl`` under ``logdir`` into TensorBoard runs
    under ``out``. Returns ``{run_name: n_scalars_written}``."""
    from torch.utils.tensorboard import SummaryWriter

    written: Dict[str, int] = {}
    for path in sorted(glob.glob(os.path.join(logdir, "*.jsonl"))):
        run = os.path.splitext(os.path.basename(path))[0]
        run_dir = os.path.join(out, run)
        marker = os.path.join(run_dir, ".jsonl2tb_offset")
        offset = 0
        if os.path.exists(marker):
            with open(marker) as f:
                offset = int(f.read().strip() or 0)
        n, writer = 0, None
        with open(path) as f:
            f.seek(offset)
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    break
                if not line.endswith("\n"):
                    # the torn tail of a live run: left for the next pass
                    f.seek(pos)
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # a malformed full line is skipped for good
                step = int(rec.pop("step", 0))
                if writer is None:  # no event file for an empty delta
                    writer = SummaryWriter(run_dir)
                for key, val in rec.items():
                    if isinstance(val, (int, float)):
                        writer.add_scalar(key, val, global_step=step)
                        n += 1
            offset = f.tell()
        if writer is not None:
            writer.close()
            with open(marker, "w") as f:
                f.write(str(offset))
        written[run] = n
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logdir", help="experiment log directory (holds *.jsonl metric streams)")
    ap.add_argument("--out", default=None, help="TensorBoard output directory "
                                                "(default <logdir>/tb)")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="export again every N seconds until interrupted")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.logdir, "tb")
    while True:
        written = export_dir(args.logdir, out)
        print(f"[jsonl2tb] wrote {sum(written.values())} scalars across {len(written)} "
              f"run(s) -> {out}", flush=True)
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    raise SystemExit(main())
