"""One run of one cell of the tgtc_torch benchmark on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the program's kernel libraries loaded or built, weights and
inputs made on the device from ``--seed``, the warm-up) is timed from the
start of this process to the first timed unit. Then the cell's closed loop
runs for ``--seconds`` (:mod:`benchmark.harness.loops`), the device's peak
memory is read, the program's state is freed and the check runs against the
plain reference (:mod:`benchmark.reference`). With ``--trace 1`` the window
is followed by the host's sub-window of step calls (train cells) and a short
window under ``torch.profiler``, and the per-layer metrics are reported in
place of the end-to-end ones. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, end standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tgtc")
# units under the profiler: steps without a fetch (a fetch every 100 steps
# would break the whole-window rule; the unprofiled time a step holds it)
TRACE_UNITS = {"train": 20, "view": 2}
HOST_STEPS = 30


def cache_env(root: Path) -> None:
    """Every build and kernel cache in the checkout, at fixed paths; no
    library of the run loads JAX."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def end_to_end(kind: str, window: dict, setup_s: float) -> dict:
    out = {"setup_s": setup_s}
    if kind == "train":
        out["train_steps_per_s"] = window["units"] / window["seconds"]
    else:
        out["frames_per_s"] = window["units"] / window["seconds"]
        out["frame_ms_p90"] = 1e3 * statistics.quantiles(window["latencies"], n=10)[-1]
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             extra: bool = False) -> dict:
    """Set-up, the window, (the trace), the check. Returns the result's
    fields and the readings of ``correct``."""
    import torch

    from benchmark.harness import loops
    from benchmark.harness import spec as S

    drv = S.driver(cell.workload["driver"])
    on_card = torch.device(device).type == "cuda"
    t_build = time.perf_counter()
    sut = drv.build(cell.config, cell.workload["traffic"], seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"[setup] {t_build - t_start:.3f} s to the driver module, {setup_s:.3f} s with the cell "
          f"built and warm", file=sys.stderr, flush=True)
    loop = loops.train_window if sut.kind == "train" else loops.view_window
    window = loop(sut, seconds)
    metrics = end_to_end(sut.kind, window, setup_s)
    result = {"attempted": window["units"], "window": window}
    if trace:
        from benchmark.harness import trace as TR

        host_ms = loops.host_step_ms(sut, HOST_STEPS) if sut.kind == "train" else None
        unit = loops.step_unit(sut) if sut.kind == "train" else loops.frame_unit(sut)
        tr = TR.profile_units(unit, TRACE_UNITS[sut.kind])
        ctx = TR.Context(cell.config, sut.work(), window["seconds"] / window["units"], tr,
                         host_ms)
        metrics = {}
        for name in cell.per_layer:
            value = S.metric_reader(name).read(ctx)
            if value is not None:
                metrics[name] = value
        result["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                           "breakdown": TR.breakdown(tr)}
    result["metrics"] = metrics
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    if sut.kind == "train":
        readings = sut.check(window["losses"], extra)
        result["failed"] = int(readings["program"]["nonfinite_losses"])
    else:
        readings = sut.check(window["frames"], extra)
        result["failed"] = sum(int(not bool(torch.isfinite(f).all())) for f in window["frames"])
    result["readings"] = readings
    return result


def judge(readings: dict, limits: dict):
    """Each compared number beside its limit, and whether all hold; a number
    over its limit, or one without a reading, is not correct."""
    checked = {k: {"value": readings.get(k, float("nan")), "limit": lim}
               for k, lim in limits.items()}
    return checked, all(v["value"] <= v["limit"] for v in checked.values())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    cache_env(ROOT)
    import torch

    from benchmark.harness import spec as S

    cell = S.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3

    checked, correct = judge(res["readings"]["program"], cell.workload["limits"])
    wanted = cell.per_layer if args.trace else cell.end_to_end
    missing = [m for m in cell.end_to_end if not args.trace and m not in res["metrics"]]
    if missing:
        print(f"end-to-end metrics not measured: {missing}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": {k: {"value": res["metrics"][k], "unit": cell.units[k]}
                       for k in wanted if k in res["metrics"]},
           "device": device}
    if args.trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        out["breakdown"] = res["trace"]["breakdown"]
    out["checked"] = checked
    for k, v in checked.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
