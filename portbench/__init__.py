"""The PyTorch and CUDA port's benchmark: `python3 portbench/run.py --help`."""
