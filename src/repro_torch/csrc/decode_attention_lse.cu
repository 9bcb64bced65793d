// The decode kernel on one rank's slice of a sequence-sharded K/V cache (the
// `kvseq` layout), writing each row's log-sum-exp: decode_attention.cu's body
// compiled with DCO_DECODE_SLICE defined, whose entry point is then
// dco_decode_attention_lse (see the note on the slice kernel there).  A
// translation unit of its own, so that nvcc builds the two variants in
// parallel and the serving kernel keeps its code.
//
// Replaces no Pallas kernel of its own: the reference's decode attention
// (src/repro/kernels/decode_attention/kernel.py::decode_kernel) under GSPMD,
// which splits the cache's sequence over the mesh and sums the partial
// softmaxes around the reference's gqa_attention.  Bound on an H100: bytes,
// as the serving kernel (the slice's live K/V rows read once).

#define DCO_DECODE_SLICE
#include "decode_attention.cu"
