"""The token loader over the store (`pipeline`), a line-for-line copy of
`repro/data/pipeline.py`."""
