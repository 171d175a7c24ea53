from .ops import attention, flash_attention_fwd
from .ref import flash_attention_ref, flash_attention_segmented_ref

__all__ = ["attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_segmented_ref"]
