"""90th percentile of issue → first token at the app, ms, over every call
issued in the window; a failed, unfinished or refused call counts as
+inf (``pb_cell.ttfts``).  Read in the traced run: the profiler's cost
on the host is in it."""
import pb_stats


def read(run):
    t = run.extras["ttfts"]
    return pb_stats.percentile(t, 90) if t else None
