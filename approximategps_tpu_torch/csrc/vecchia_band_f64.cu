// The f64 entry point of the Vecchia band kernel; the kernel and its notes
// are in vecchia_band.cu.
#define AGP_VECCHIA_BAND_T double
#define AGP_VECCHIA_BAND_ENTRY agp_vecchia_band_f64
#include "vecchia_band.cu"
