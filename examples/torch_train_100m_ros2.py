"""End-to-end run on the PyTorch port: train the ~100M-parameter dense
LM for a few hundred steps with the full ROS2 storage path, on the CUDA
card.

    PYTHONPATH=src python examples/torch_train_100m_ros2.py              # full
    PYTHONPATH=src python examples/torch_train_100m_ros2.py --steps 30   # quick
    PYTHONPATH=src python examples/torch_train_100m_ros2.py --device cpu

The counterpart of `examples/train_100m_ros2.py`. The run is
preemption-safe: kill it and re-run with --resume to continue from the
last committed checkpoint in the object store; --inject-failure-at N kills
a storage device mid-run to drill replica reads.
"""
import sys

from repro_torch.launch import train


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    defaults = ["--arch", "dense-100m", "--steps", "300",
                "--global-batch", "8", "--seq", "256",
                "--microbatches", "2", "--ckpt-every", "50",
                "--storage-mode", "dpu", "--transport", "rdma"]
    # user-supplied flags win over defaults
    user_keys = {a for a in argv if a.startswith("--")}
    merged = []
    i = 0
    while i < len(defaults):
        k = defaults[i]
        if k in user_keys:
            i += 2
            continue
        merged.append(defaults[i])
        if i + 1 < len(defaults) and not defaults[i + 1].startswith("--"):
            merged.append(defaults[i + 1])
            i += 2
        else:
            i += 1
    return train.main(merged + argv)


if __name__ == "__main__":
    main()
