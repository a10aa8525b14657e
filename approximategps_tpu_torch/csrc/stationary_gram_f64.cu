// The f64 entry point of the fused stationary Gram; the kernel and its notes
// are in stationary_gram.cu.
#define AGP_STATIONARY_GRAM_T double
#define AGP_STATIONARY_GRAM_ENTRY agp_stationary_gram_f64
#include "stationary_gram.cu"
