from .ops import (k_splits, msb_matmul, msb_matmul_experts, msb_unembed,
                  packed_matmul, packed_matmul_experts, plan, qtensor_matmul,
                  to_kernel_layout, unembed_plan)
from .ref import (dequant_ref, msb_matmul_experts_ref, msb_matmul_ref,
                  msb_unembed_ref, unpack_ref)

__all__ = ["dequant_ref", "k_splits", "msb_matmul", "msb_matmul_experts",
           "msb_matmul_experts_ref", "msb_matmul_ref", "msb_unembed",
           "msb_unembed_ref", "packed_matmul", "packed_matmul_experts",
           "plan", "qtensor_matmul", "to_kernel_layout", "unembed_plan",
           "unpack_ref"]
