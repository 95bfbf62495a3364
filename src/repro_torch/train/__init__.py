"""Training of the port: AdamW (`optimizer`) and the train step
(`trainer`), the counterparts of `repro/train/`."""
