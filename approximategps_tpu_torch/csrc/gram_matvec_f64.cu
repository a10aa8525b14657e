// The f64 entry point of the fused Gram matvec; the kernel and its notes
// are in gram_matvec.cu.
#define AGP_GRAM_MATVEC_T double
#define AGP_GRAM_MATVEC_ENTRY agp_gram_matvec_f64
#include "gram_matvec.cu"
