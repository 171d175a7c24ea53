from .ops import paged_attention_decode
from .ref import attend_gathered, paged_attention_decode_ref

__all__ = ["attend_gathered", "paged_attention_decode",
           "paged_attention_decode_ref"]
