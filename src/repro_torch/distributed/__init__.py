"""Checkpoints through the store (`checkpoint`) and the fault drills of
the training runtime (`fault`), the counterparts of `repro/distributed/`."""
