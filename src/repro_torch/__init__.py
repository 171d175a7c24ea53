"""repro_torch — the MSB quantize → pack → serve path in PyTorch and CUDA.

A port of the JAX package ``repro`` (which stays the reference) to one
NVIDIA H100. The layout mirrors ``repro``: ``configs``, ``core`` (the MSB
solver and storage formats), ``kernels`` (hand-written Hopper kernels,
each beside its plain PyTorch version), ``models`` and ``serve``.

Rules every module follows:

* imports ``torch`` and ``numpy`` only — never ``jax`` or ``repro``;
* entry points take ``device=``; ``None`` means ``"cuda"`` and raises when
  no CUDA device exists (``device.resolve_device``) — the CPU is used only
  when the caller asks for it;
* kernel wrappers dispatch on the tensor's device alone: a CPU tensor takes
  the plain PyTorch version, a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
