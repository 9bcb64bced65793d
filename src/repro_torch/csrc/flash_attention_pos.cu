// The flash-attention forward's position variant: flash_attention.cu's body
// compiled with DCO_FLASH_POS defined, whose entry point is then
// dco_flash_attention_pos (dco_flash_attention hands a call with a position
// table to it; see the note on explicit positions there).  A translation unit
// of its own, so that nvcc builds the two variants in parallel and the serving
// kernels keep their code and registers.
//
// Replaces what the Pallas kernel `flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:61) does not compute: the JAX
// package's `forward` and `prefill` mask by explicit positions in the plain
// `gqa_attention` (src/repro/models/layers.py:199-212).  Bound on an H100: as
// the serving kernel, counting the (row, column) pairs the tables leave
// visible.

#define DCO_FLASH_POS
#include "flash_attention.cu"
