"""attn_prefill_roofline: the least time an H100 could take for the traced
prefill's attention (portbench/flops.py `attention_bound_s` at the wave's
shape, a call a layer), over the device time of the attention operations
that started in the traced prefill, in percent. Which operations are the
attention's is listed a file an implementation in names/ (substrings of
kernel names, one a line)."""
from pathlib import Path

from portbench import flops
from portbench.check import reference

NAMES = [line.strip() for f in sorted((Path(__file__).parent / "names")
                                      .glob("*.txt"))
         for line in f.read_text().splitlines() if line.strip()]


def read(rec):
    ops = rec.get("trace", {}).get("ops_by_phase", {}).get("prefill_host", {})
    n, seconds = 0, 0.0
    for name, (count, s) in ops.items():
        if any(k in name for k in NAMES):
            n += count
            seconds += s
    if not n or seconds <= 0:
        return None
    sh, _ = reference(rec["config"])
    bound = flops.attention_bound_s(rec["batch"],
                                    rec["window"]["waves"][0]["prompt_len"],
                                    sh.heads, sh.kv_heads, sh.head_dim)
    return 100.0 * n * bound["bound_s"] / seconds
