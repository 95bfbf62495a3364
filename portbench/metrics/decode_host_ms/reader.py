"""decode_host_ms: the host's own time a decode step, outside its wait for
the card: the mean over the decode steps of the wave traced with the
program's spans and no profiler (`portbench/spans.py` `bare_wave`) of
`decode.step` less its `decode.token_read`, in ms."""
from portbench.spans import bare_table


def read(rec):
    spans = bare_table(rec)
    step, wait = spans.get("decode.step"), spans.get("decode.token_read")
    if not step or not wait or step["count"] != wait["count"]:
        return None
    return (step["total_s"] - wait["total_s"]) * 1e3 / step["count"]
