"""prompt_read_ms.p95: the 95th percentile over the requests sent inside
the window of the host time from a request's send to the completion of
its last store read."""
from portbench.stats import in_window, percentile


def read(rec):
    return percentile([(r["read_done"] - r["send"]) * 1e3
                       for r in rec["window"]["requests"]
                       if in_window(rec, r["send"])], 95)
