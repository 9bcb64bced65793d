from .ops import decode_attention
from .ops import decode_attention_lse
from .ref import decode_attention_lse_ref
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_lse", "decode_attention_lse_ref",
           "decode_attention_ref"]
