// The f64 entry point of the band rows from prebuilt Grams; the kernel and
// its notes are in band_rows.cu.
#define AGP_BAND_ROWS_T double
#define AGP_BAND_ROWS_ENTRY agp_band_rows_f64
#include "band_rows.cu"
