from .ops import flash_attention_fwd
from .ref import flash_attention_ref, flash_attention_segmented_ref

__all__ = ["flash_attention_fwd", "flash_attention_ref",
           "flash_attention_segmented_ref"]
