"""The readings that the comparison's limits are set from, at a cell's own
size: for each seed, a run of the program at the cell's load for a short
window, then the plain reference (fp32) read against the program and
against the control, the same reference computed in fp8 in the
program's place.  A benchmark run never runs this.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 \
        --seconds 20

prints one JSON line a seed: {"seed", "program": {...}, "control_fp8":
{...}, "verdict": {...}}, where the verdict is the harness's own
comparison (``pb_judge.verdict``) of each side's numbers against the
cell's limits file: the program should come out correct, the control
not.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def readings(workload: str, seed: int, seconds: float, device="cuda",
             root=None, precisions=("fp8",)):
    import pb_cell
    import pb_judge
    root = Path(root) if root else HERE.parent
    wl, conf, mix, limits, *_ = pb_cell.cell_spec(root, workload)
    cell = pb_cell.Cell(conf, mix, seed, device)
    cell.window(seconds, None)
    counts = {"calls_unfinished": float(sum(
        not c.stream.done for c in cell.calls)), "calls_failed": float(sum(
            c.stream.done and c.stream.error is not None
            for c in cell.calls)), "calls_refused": float(cell.refused)}
    picked = pb_cell.sample_contexts(cell, seed)
    subjects = {cid: pb_judge.program_subject(
        cell.records[cid], cell.svc.contexts[cid], cell.geom.cs)
        for cid in picked}
    records, params, cfg, geom = cell.records, cell.params, cell.cfg, cell.geom
    cell.close()
    del cell
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    rd, extra = pb_cell.compare(cfg, params, geom, records, subjects,
                                also=precisions)
    out = {"program": rd.numbers(), "verdict": {}}
    for p, r in extra.items():
        out["control_" + p] = r.numbers()
    out["program"].update(counts)
    for side in [k for k in out if k != "verdict"]:
        # the control replays the program's calls: its counts are those
        nums = dict(out[side], **counts)
        out["verdict"][side] = pb_judge.verdict(nums, limits)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]
    for s in args.seeds:
        t0 = time.perf_counter()
        out = readings(args.workload, s, args.seconds)
        out["seed"], out["wall_s"] = s, time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
