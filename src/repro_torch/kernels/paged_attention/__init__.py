from .ops import (paged_attention, paged_attention_decode,
                  paged_attention_decode_quant, paged_attention_kv_quant)
from .ref import (attend_gathered, paged_attention_decode_quant_ref,
                  paged_attention_decode_ref)

__all__ = ["attend_gathered", "paged_attention", "paged_attention_decode",
           "paged_attention_decode_quant", "paged_attention_decode_quant_ref",
           "paged_attention_decode_ref", "paged_attention_kv_quant"]
