"""Hand-written Hopper kernels of the port.

Each kernel directory carries kernel.py (builds and launches the CUDA
kernel from `repro_torch/csrc/`), ops.py (the public wrapper: a CUDA
tensor goes to the kernel, a CPU tensor to the plain PyTorch version)
and ref.py (the numpy oracle and the plain PyTorch version).

  rs_parity       — GF(256) Reed-Solomon parity for ec(k,p) containers
  flash_attention — online-softmax GQA attention, forward (prefill and
                    training) and backward recomputed from lse (training);
                    split-KV decode over the bf16 KV cache (serving)
  rglru_scan      — the RG-LRU linear recurrence of the hybrid family's
                    recurrent blocks (prefill and decode), and its
                    adjoint in reverse (training)
  rwkv6_scan      — the chunked RWKV6 WKV recurrence of the ssm family's
                    time-mix blocks (prefill)
  stream_cipher   — the counter-mode XOR keystream of the storage path's
                    inline crypto (core/smartnic.py InlineCrypto), on the card
  fletcher        — the wide Fletcher extent checksum of the storage engine
                    (core/media.py fletcher64), on the card
"""
