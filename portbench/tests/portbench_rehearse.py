"""Rehearse a run of the benchmark on the CPU at a tiny size.

``checkout(tmp)`` copies the benchmark into ``tmp`` with every cell's
configuration cut to a tiny width and depth and its traffic to a few
short calls; ``main`` runs one cell there through ``pb_cell.run`` on the
CPU, skipping the look for a card, with ``FakeTrace`` standing for the
profiler (it names each extend's and each switch-out's launches as the
card's trace does, so every reader finds something).  Used by the tests
in this directory, in a subprocess of its own.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent

TINY_DENSE = {"hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 512}
TINY_MLA = {"hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 4, "kv_lora_rank": 32,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
            "n_routed_experts": 4, "num_experts_per_tok": 2,
            "moe_intermediate_size": 48, "n_shared_experts": 2,
            "num_hidden_layers": 2, "vocab_size": 512}
# tiny CPU readings, program / fp8 control, over seeds 5-7 of both
# dense mixes: code_dev 0.0014-0.0022 / 0.0126-0.0155, scale_dev
# 0.0029-0.0046 / 0.021-0.066
TINY_LIMITS = {"tokens_compared": {"min": 40}, "code_dev": {"max": 0.008},
               "scale_dev": {"max": 0.013}}
TINY_SERVICE = {"max_ctx_len": 512, "pool_pages_16": 0}
TINY_MIX = {"contexts_per_app": 2,
            "history": {"median": 200, "sigma": 0.3, "lo": 120, "hi": 300},
            "prompt": {"median": 8, "sigma": 0.5, "lo": 4, "hi": 20},
            "output": {"median": 4, "sigma": 0.4, "lo": 2, "hi": 6},
            "round": 4, "calls_per_app": 16}


def checkout(tmp: Path) -> Path:
    """A copy of the benchmark in ``tmp``, cut to the CPU."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        p = root / c["file"]
        conf = json.loads(p.read_text())
        conf.update(TINY_DENSE if conf["port"]["family"] == "dense"
                    else TINY_MLA)
        conf["service"].update(TINY_SERVICE)
        conf["service"]["decode_batch"] = min(conf["service"]["decode_batch"],
                                              4)
        p.write_text(json.dumps(conf))
    for p in (root / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(TINY_MIX)
        mix["apps"] = min(mix["apps"], 4)
        if "kv_budget_mib" in mix:
            mix["kv_budget_mib"] = 64
        p.write_text(json.dumps(mix))
    # a tiny run on a busy CPU serves fewer tokens than a window on the
    # card: the sample's floor is the card's business, not the harness's;
    # and at two layers of width 64 both sides of the comparison read
    # lower than at the cell's size, so the encoding's limits are set
    # from tiny readings as the cell's are from the card's
    for p in (root / "portbench" / "limits").glob("*.json"):
        lim = json.loads(p.read_text())
        lim.update(TINY_LIMITS)
        p.write_text(json.dumps(lim))
    return root


class FakeTrace:
    """Stands for ``pb_trace.DeviceTrace`` on the CPU: after the window it
    lays one op per extend layer, per switch-out and per decode round
    inside the host spans."""

    spans = None

    def __init__(self):
        self.ops, self.t0, self.t1 = [], 0.0, 0.0

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        from pb_trace import Op
        self.t1 = time.perf_counter()
        for s in FakeTrace.spans.items:
            if s.t0 < self.t0:
                continue
            d = (s.t1 - s.t0) / 4
            if s.name == "begin_call":
                self.ops.append(Op("attn_density_tc_kernel<4, 16, 16, true, true>(Args)",
                                   s.t0, d))
            elif s.name == "finish_call":
                self.ops.append(Op(
                    "void quant_leaves_kernel<__nv_bfloat16, 4>(Leaves)",
                    s.t0, d))
            else:
                self.ops.append(Op("decode", s.t0, d))
        self.ops.sort(key=lambda o: o.t0)

    @property
    def window_s(self):
        return self.t1 - self.t0

    def busy(self):
        from pb_trace import DeviceTrace
        return DeviceTrace.busy(self)

    def by_name(self, pattern):
        from pb_trace import DeviceTrace
        return DeviceTrace.by_name(self, pattern)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    root = Path(args.root)
    sys.path[:0] = [str(REPO / "src"), str(root / "portbench")]
    import torch
    torch.set_num_threads(1)
    import pb_cell
    import pb_faults

    orig = pb_cell.Cell.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        FakeTrace.spans = self.spans
    pb_cell.Cell.__init__ = init
    brk = pb_faults.FAULTS[args.fault] if args.fault else None
    return pb_cell.run(args, time.perf_counter(), device="cpu",
                       trace_factory=FakeTrace, break_program=brk, root=root)


if __name__ == "__main__":
    sys.exit(main())
