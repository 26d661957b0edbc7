"""Share of the roofline that the codec's quantize kernel reaches in the
traced window, %: for each launch (a chunk's leaves at the bits its name
carries) the least time its bytes take at the card's bandwidth
(``rooflines/chunk_quant.py``), over the launches' device time."""
import re


def read(run):
    ops = run.trace.by_name(r"quant_leaves_kernel")
    if not ops:
        return None
    rl, pk = run.roofline("chunk_quant"), run.peaks
    t_min = dev = 0.0
    for o in ops:
        m = re.search(r"quant_leaves_kernel<([^,]+),\s*(\d)>", o.name)
        if m is None:
            return None
        fl, by = rl.launch_cost(run.cfg, run.geom.cs, int(m.group(2)),
                                m.group(1).strip())
        t_min += max(fl / pk["bf16_flops_per_s"], by / pk["hbm_bytes_per_s"])
        dev += o.dur
    return 100.0 * t_min / dev if dev else None
