"""The model FLOPs of every token the model processed in the traced
window (each prompt token of an extend and each fed decode token; a
bucket's pads are not model work; ``pb_flops.py``), over the window's
length times the card's bf16 peak, %."""
import pb_flops


def read(run):
    total = 0.0
    for s in run.spans.items:
        if s.t0 < run.t0 or s.t1 > run.t1:
            continue
        if s.name == "begin_call":
            n0 = s.info["n0"]
            total += pb_flops.tokens(run.cfg, range(n0, n0 + s.info["M"]))
        elif s.name == "decode_round":
            total += pb_flops.tokens(run.cfg, s.info["pos"])
    if not total:
        return None
    return 100.0 * total / (run.trace.window_s
                            * run.peaks["bf16_flops_per_s"])
