// The flash-attention backward's position variant: flash_attention_bwd.cu's
// `_ext_` kernels compiled with DCO_FLASH_POS defined, reading a (B, S)
// positions table, whose entry point is then dco_flash_attention_bwd_pos
// (dco_flash_attention_bwd hands a call with a table to it; see the note on
// explicit positions there).  A translation unit of its own, so that nvcc
// builds the two in parallel and the kernels without a table keep their code.
//
// Replaces what the JAX package gets from autodiff of `gqa_attention` at
// explicit positions (src/repro/models/layers.py:124, masked at :199-212);
// the Pallas forward `flash_kernel` (src/repro/kernels/flash_attention/
// kernel.py:61) has no backward.  Bound on an H100: as the backward without a
// table, counting the (row, column) pairs the table leaves visible.

#define DCO_FLASH_POS
#include "flash_attention_bwd.cu"
