"""90th percentile of the service's own switch-in time of each call
(``records[*]["switch_s"]``: reclaim, disk restore and admission of the
missing chunks), ms, over the window's calls."""
import pb_stats


def read(run):
    sw = [c.switch_s * 1e3 for c in run.calls if c.switch_s is not None]
    return pb_stats.percentile(sw, 90) if sw else None
