"""90th percentile of the wait from an app issuing a call to the router
admitting it (the start of the harness's span around ``begin_call``), ms,
over the calls of the traced window."""
import pb_stats


def read(run):
    start = {s.info["req"]: s.t0 for s in run.spans.items
             if s.name == "begin_call"}
    waits = [(start[id(c.stream.request)] - c.t_submit) * 1e3
             for c in run.calls if id(c.stream.request) in start]
    return pb_stats.percentile(waits, 90) if waits else None
