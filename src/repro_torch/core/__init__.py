"""MSB dynamic-grouping quantization — the paper's core contribution."""
from .objective import (grouping_cost, group_sse, lambda_bounds,
                        lambda_from_tilde, prefix_sums, reconstruction_mse,
                        xnor_closed_form)
from .grouping import (dp_boundaries, kmeans1d_boundaries, solve_blocks,
                       solve_flat, windowed_dp_boundaries)
from .quantize import (DQScales, KVQuantSpec, PackedQTensor, QTensor,
                       dequantize, double_quantize, kv_dequantize_pages,
                       kv_native_page_bytes, kv_quantize_pages, map_tensors,
                       pack_codes_int4, pack_qtensor, packed_dequantize,
                       packed_gather, quantize_blockwise, quantize_pertensor,
                       storage_bits_per_weight, unpack_codes_int4)
from .policy import (QuantPolicy, dequantize_params, pack_params, param_bits,
                     quantize_params, tp_localize, tp_partition_params,
                     tp_shard)
from . import baselines, reference

__all__ = [
    "DQScales", "KVQuantSpec", "PackedQTensor", "QTensor", "QuantPolicy",
    "baselines", "dequantize", "dequantize_params", "double_quantize",
    "dp_boundaries", "grouping_cost", "group_sse", "kmeans1d_boundaries",
    "kv_dequantize_pages", "kv_native_page_bytes", "kv_quantize_pages",
    "lambda_bounds", "lambda_from_tilde", "map_tensors", "pack_codes_int4",
    "pack_params", "pack_qtensor", "packed_dequantize", "packed_gather",
    "param_bits", "prefix_sums", "quantize_blockwise", "quantize_params",
    "quantize_pertensor", "reconstruction_mse", "reference", "solve_blocks",
    "solve_flat", "storage_bits_per_weight", "tp_localize",
    "tp_partition_params", "tp_shard", "unpack_codes_int4",
    "windowed_dp_boundaries", "xnor_closed_form",
]
