"""ttft_p95_ms: the 95th percentile over every request whose first token
came inside the window, from its client's send (before its store reads)
to its first token (its wave's start plus the engine's prefill time of
that wave)."""
from portbench.stats import in_window, percentile


def read(rec):
    return percentile([(r["first_token"] - r["send"]) * 1e3
                       for r in rec["window"]["requests"]
                       if "first_token" in r
                       and in_window(rec, r["first_token"])], 95)
