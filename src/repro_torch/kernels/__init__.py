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
tensors and launches the kernel for CUDA tensors. The reference's public
dispatchers (``paged_attention``, ``paged_attention_kv_quant``,
``attention``) are thin aliases of those wrappers: the device alone
decides, and their ``use_kernel`` flag may only confirm it
(``check_use_kernel``).
"""


def check_use_kernel(t, use_kernel, what):
    """The reference's ``use_kernel`` flag on tensor ``t``, where the
    device alone decides (the kernel for a CUDA tensor, the plain version
    for a CPU one): None or the device's own choice pass; True on a CPU
    tensor raises ValueError (the port has no kernel interpreter), and
    False on a CUDA tensor too (nothing falls back to the plain version
    on the card)."""
    if use_kernel is not None and bool(use_kernel) != t.is_cuda:
        raise ValueError(
            f"{what}(use_kernel={bool(use_kernel)}) on a "
            f"{'CUDA' if t.is_cuda else 'CPU'} tensor: the device decides "
            "(the kernel on CUDA, its plain version on the CPU)")
