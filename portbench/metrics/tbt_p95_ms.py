"""95th percentile of every gap between two tokens of one call, as the
apps receive them (the stream's stamps), ms, over the window's calls."""
import pb_stats


def read(run):
    gaps = [g * 1e3 for c in run.calls
            for g in pb_stats.gaps(c.stream.token_times)]
    return pb_stats.percentile(gaps, 95) if gaps else None
