"""The readings that a cell's correctness limits are set from: in one
process, the program's numbers on many seeds (the lower readings) and the
control's on some of them (the upper readings). The benchmark's own runs
never run this.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

Each seed is a short window at the cell's own load (its clients, its
pool), judged as a run judges it. The control is the plain reference with
TF32 convolutions (the precision below the configuration's float32) put
in the program's place and judged by the same numbers; a fault of the
driver's ``FAULTS`` can be planted in the program for further seeds. One
JSON line a seed, then a summary: per number the largest program reading,
the smallest control reading and the smallest reading under the fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from benchlib import core  # noqa: E402


def main(argv=None, device="cuda", overrides=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None,
                    help="a fault of the driver's FAULTS planted in the "
                         "program for --fault-seeds")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    carry, lower, upper, fault = None, {}, {}, {}
    for seed, planted in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.fault_seeds]):
        run = core.Run(cell, seed, args.seconds, False, device, overrides)
        driver = core.load_module("drivers", run.mix["driver"])
        undo = driver.FAULTS[args.fault]() if planted else None
        try:
            state = driver.prepare(run, carry)
            result = driver.measure(run, state)
            driver.collect(run, state, result)
        finally:
            if undo:
                undo()
        carry = {k: state[k] for k in ("codec",) if k in state}
        pool = state.pop("pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
        line = {"seed": seed, "requests": len(result["records"]),
                "failed": sum("error" in r for r in result["records"])}
        numbers = driver.judge(run, state, result)
        if planted:
            line["fault " + args.fault] = numbers
            for k, v in numbers.items():
                fault[k] = min(fault.get(k, float("inf")), v)
        else:
            line["program"] = numbers
            for k, v in numbers.items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in args.control_seeds and not planted:
            line["control"] = driver.control(run, state, result)
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line, default=float), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "fault": fault}, default=float),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
