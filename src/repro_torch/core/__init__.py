"""MSB dynamic-grouping quantization — the paper's core contribution."""
from .objective import prefix_sums
from .grouping import dp_boundaries, solve_blocks
from .quantize import (PackedQTensor, QTensor, dequantize, map_tensors,
                       pack_codes_int4, pack_qtensor, packed_dequantize,
                       packed_gather, quantize_blockwise, unpack_codes_int4)
from .policy import QuantPolicy, dequantize_params, pack_params, \
    param_bits, quantize_params

__all__ = [
    "PackedQTensor", "QTensor", "QuantPolicy", "dequantize",
    "dequantize_params", "dp_boundaries", "map_tensors", "pack_codes_int4",
    "pack_params", "pack_qtensor", "packed_dequantize", "packed_gather",
    "param_bits", "prefix_sums", "quantize_blockwise", "quantize_params",
    "solve_blocks",
    "unpack_codes_int4",
]
