"""latency_p95_ms: the 95th percentile over every request completed
inside the window, from its client's send to its reply (run_wave's
return)."""
from portbench.stats import in_window, percentile


def read(rec):
    return percentile([(r["reply"] - r["send"]) * 1e3
                       for r in rec["window"]["requests"]
                       if "reply" in r and in_window(rec, r["reply"])], 95)
