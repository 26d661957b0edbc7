"""Mean wall time of one batched decode round (the harness's span around
``decode_step_batch``), ms, over the rounds of the traced window."""


def read(run):
    rs = [s for s in run.spans.items if s.name == "decode_round"
          and s.t0 >= run.t0 and s.t1 <= run.t1]
    return sum(s.t1 - s.t0 for s in rs) / len(rs) * 1e3 if rs else None
