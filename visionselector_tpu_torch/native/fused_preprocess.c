/* Fused normalize + patchify for the host-side data loader.
 *
 * The port's copy of visionselector_tpu/native/fused_preprocess.c.
 * Replaces the numpy pipeline `(x/255 - mean)/std` -> transpose ->
 * 9-D reshape/transpose/reshape (preprocess/image.py:normalize_image,
 * patchify) with one cache-friendly pass: for every output patch row we
 * gather its pixels straight from the (T, H, W, 3) frame buffer, normalize,
 * and write the row contiguously — no float64 intermediates, no transposed
 * copies. OpenMP-parallel over patch rows. It runs on the host before the
 * pixel rows are copied to the card, so plain C is the right tool.
 *
 * Row layout (must match patchify exactly):
 *   row = ((gt * GHB + ghb) * GWB + gwb) * M*M + mh * M + mw
 *   col = ((c * TP + tp) * PS + ph) * PS + pw
 *   src frame t = min(gt * TP + tp, T - 1)   (temporal repeat of last frame)
 *   src y = (ghb * M + mh) * PS + ph,  x = (gwb * M + mw) * PS + pw
 */

#include <stdint.h>

static void fused_one(
    const unsigned char *frames_u8, const double *frames_f64,
    float *out,
    long T, long H, long W,
    long PS, long TP, long M,
    const double *mean, const double *std_,
    long row)
{
    const long GH = H / PS, GW = W / PS;
    const long GHB = GH / M, GWB = GW / M;
    const long rows_per_t = GHB * GWB * M * M;

    long r = row;
    const long gt = r / rows_per_t; r %= rows_per_t;
    const long ghb = r / (GWB * M * M); r %= (GWB * M * M);
    const long gwb = r / (M * M); r %= (M * M);
    const long mh = r / M;
    const long mw = r % M;

    const long y0 = (ghb * M + mh) * PS;
    const long x0 = (gwb * M + mw) * PS;
    /* Accumulate in double with the numpy fallback's exact expression
       ((x/255 - mean) / std, see preprocess/image.py:normalize_image) so eval outputs
       do not depend on whether a C compiler was present (the division costs
       nothing next to the memory traffic). */
    float *dst = out + row * (3 * TP * PS * PS);
    for (int c = 0; c < 3; c++) {
        for (long tp = 0; tp < TP; tp++) {
            long t = gt * TP + tp;
            if (t >= T) t = T - 1;  /* temporal repeat */
            for (long ph = 0; ph < PS; ph++) {
                const long y = y0 + ph;
                const long base = ((t * H + y) * W + x0) * 3 + c;
                for (long pw = 0; pw < PS; pw++) {
                    double v;
                    if (frames_u8)
                        v = (double)frames_u8[base + pw * 3] / 255.0;
                    else
                        v = frames_f64[base + pw * 3] / 255.0;
                    *dst++ = (float)((v - mean[c]) / std_[c]);
                }
            }
        }
    }
}

void fused_normalize_patchify_u8(
    const unsigned char *frames, float *out,
    long T, long H, long W, long PS, long TP, long M,
    const double *mean, const double *std_)
{
    const long GT = (T + TP - 1) / TP;
    const long n_rows = GT * (H / PS) * (W / PS);
    long row;
#pragma omp parallel for schedule(static)
    for (row = 0; row < n_rows; row++)
        fused_one(frames, 0, out, T, H, W, PS, TP, M, mean, std_, row);
}

void fused_normalize_patchify_f64(
    const double *frames, float *out,
    long T, long H, long W, long PS, long TP, long M,
    const double *mean, const double *std_)
{
    const long GT = (T + TP - 1) / TP;
    const long n_rows = GT * (H / PS) * (W / PS);
    long row;
#pragma omp parallel for schedule(static)
    for (row = 0; row < n_rows; row++)
        fused_one(0, frames, out, T, H, W, PS, TP, M, mean, std_, row);
}
