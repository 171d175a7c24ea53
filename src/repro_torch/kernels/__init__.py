"""Hand-written Hopper kernels, each beside its plain PyTorch version.

msb_matmul       — fused MSB 4-bit dequantize + matmul (every packed
                   projection and the k-blocked unembedding)
paged_attention  — decode attention streaming KV pages via block tables
                   (paged decode, and packed prefill one token per row),
                   over kv16 pools and, with the MSB dequant fused in,
                   over 8|4-bit quantized pools
flash_attention  — tiled forward attention with an online softmax (causal,
                   window, softcap, GQA, segment ids): every attention of
                   the static path's prefill and loss forward

Sources are CUDA C++ in ``repro_torch/csrc``, built by ``_build`` at first
use. Each wrapper (``ops.py``) takes the plain version (``ref.py``) for CPU
tensors and launches the kernel for CUDA tensors.
"""
