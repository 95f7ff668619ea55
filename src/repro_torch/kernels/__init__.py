"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU
kernel of the reference that the port has reached.

Each kernel ships as:
  csrc/*.cu  CUDA C++ with a plain C entry point, built at first use by
             ``kernels/_build.py`` (nvcc -> shared library -> ctypes)
  ops.py     the wrapper: checks, launches on the current stream, counts
             launches; takes the plain version for CPU tensors only
  ref.py     the plain PyTorch version the kernel is held to

Kernels: flash_attention (GQA/causal/SWA prefill self-attention), rglru
(the RG-LRU scan of recurrentgemma's recurrent blocks in prefill), rwkv6
(``wkv6``, the WKV6 matrix-state recurrence of rwkv6's time-mix blocks in
prefill).
"""
