"""dpu_op_ms: the mean wall time of `dpu.op`, an SQE's handler on an Arm
core, over the wave traced with the program's spans and no profiler
(`portbench/spans.py` `bare_wave`), in ms."""
from portbench.spans import bare_table


def read(rec):
    row = bare_table(rec).get("dpu.op")
    return row["mean_ms"] if row else None
