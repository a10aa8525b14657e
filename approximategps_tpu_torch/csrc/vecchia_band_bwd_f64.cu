// The f64 entry point of the Vecchia band pullback kernel; the kernel and its
// notes are in vecchia_band_bwd.cu.
#define AGP_VECCHIA_BAND_BWD_T double
#define AGP_VECCHIA_BAND_BWD_ENTRY agp_vecchia_band_bwd_f64
#include "vecchia_band_bwd.cu"
