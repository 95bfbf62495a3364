"""Batched serving on the PyTorch port: prompts live in the object store,
the engine prefills waves of requests and decodes with iteration-level
batching, on the CUDA card.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The counterpart of `examples/serve_batched.py`.
"""
import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    return serve.main(["--arch", "tiny-qwen3-14b", "--requests", "8",
                       "--batch", "4", "--prompt-len", "32", "--max-new",
                       "12", "--storage-mode", "dpu", "--transport", "rdma"]
                      + list(argv))


if __name__ == "__main__":
    main()
