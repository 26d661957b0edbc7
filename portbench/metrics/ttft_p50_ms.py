"""Median of issue → first token at the app, ms, over every call issued
in the window, as ``ttft_p90_ms``."""
import pb_stats


def read(run):
    t = run.extras["ttfts"]
    return pb_stats.percentile(t, 50) if t else None
