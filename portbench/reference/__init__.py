"""Plain float32 references of the blocks the benchmark serves."""
