"""Run a cell several times, one process a run, as a check does, and
summarise: each run's wall time, result line and checks; then, per
end-to-end metric, the median and the spread (the distance between the
first and third quartiles by ``statistics.quantiles(values, n=4)``, as a
share of the median).

    python3 portbench/sets.py --workload <name> --seeds 1 2 3 \
        --seconds 51 [--trace] [--out chiprun_out/sets]

Each run's standard output and error go to ``--out``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--out", default="chiprun_out/sets")
    args = p.parse_args(argv)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    vals = {}
    for s in args.seeds:
        tag = f"{args.workload}.{s}.{int(args.trace)}"
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", args.workload,
             "--seed", str(s), "--seconds", str(args.seconds), "--trace",
             str(int(args.trace))], cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        (out / f"{tag}.out").write_text(r.stdout)
        (out / f"{tag}.err").write_text(r.stderr)
        last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        print(f"== seed {s} trace {int(args.trace)} rc {r.returncode} wall "
              f"{wall:.1f} s", flush=True)
        for ln in r.stderr.splitlines():
            if ln.startswith(("calls ", "bytes ", "reference", "card",
                              "portbench", "Traceback")) or "Error" in ln:
                print("  " + ln[:300], flush=True)
        try:
            res = json.loads(last)
        except ValueError:
            print("  no result line; stderr tail:\n" + r.stderr[-3000:],
                  flush=True)
            continue
        checks = {k: v.get("value") for k, v in res.get("checks", {}).items()}
        m = {k: v["value"] for k, v in res["metrics"].items()}
        print(f"  correct {res['correct']} attempted {res['attempted']} "
              f"failed {res['failed']} peak {res['device']['memory_peak_bytes']}"
              f" busy {res['device'].get('busy_s')} window "
              f"{res['device'].get('window_s')}", flush=True)
        print(f"  metrics {json.dumps(m)}", flush=True)
        print(f"  checks {json.dumps(checks)}", flush=True)
        if "breakdown" in res:
            print(f"  breakdown {json.dumps(res['breakdown'])}", flush=True)
        for k, v in m.items():
            vals.setdefault(k, []).append(v)
    for k, v in vals.items():
        print(f"{k}: median {statistics.median(v)!r} spread {spread(v)!r} "
              f"values {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
