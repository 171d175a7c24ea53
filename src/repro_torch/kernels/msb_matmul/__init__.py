from .ops import (k_splits, msb_matmul, msb_matmul_experts, packed_matmul,
                  packed_matmul_experts, plan, qtensor_matmul,
                  to_kernel_layout)
from .ref import dequant_ref, msb_matmul_experts_ref, msb_matmul_ref

__all__ = ["dequant_ref", "k_splits", "msb_matmul", "msb_matmul_experts",
           "msb_matmul_experts_ref", "msb_matmul_ref", "packed_matmul",
           "packed_matmul_experts", "plan", "qtensor_matmul",
           "to_kernel_layout"]
