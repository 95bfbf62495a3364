"""The roofline, the counterpart of `repro/roofline/`: the analytic terms
of a step (`analytic.py`) and what a traced step dispatches, its
collectives, FLOPs, bytes and live memory (`collectives.py`, the
counterpart of `hlo.py`)."""
