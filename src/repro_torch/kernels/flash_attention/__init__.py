from .ops import FlashAttentionFn
from .ops import flash_attention
from .ops import flash_attention_bwd
from .ref import attention_bwd_ref
from .ref import attention_ref

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd",
           "attention_bwd_ref", "attention_ref"]
