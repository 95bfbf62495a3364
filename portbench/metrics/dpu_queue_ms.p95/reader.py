"""dpu_queue_ms.p95: the 95th percentile, over the SQEs of the wave traced
with the program's spans and no profiler (`portbench/spans.py`
`bare_wave`), of `dpu.queue`: an SQE's wait in the SmartNIC's submission
queue from its doorbell to an Arm core taking it, in ms."""
from portbench.spans import bare_table


def read(rec):
    row = bare_table(rec).get("dpu.queue")
    return row["p95_ms"] if row else None
