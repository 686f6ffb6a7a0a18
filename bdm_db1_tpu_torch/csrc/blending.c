/* The blending index of data/native.py: error-minimizing weighted
 * round-robin over n_datasets datasets (the loop of the JAX package's
 * data/_native/helpers.cpp build_blending_indices). Entry i takes the
 * dataset with the largest error weights[j] * (i + 1) - counts[j], the
 * first on a tie, and that dataset's next sample.
 *
 * The error is fma(weights[j], i + 1, -counts[j]): rounded once, from its
 * exact value, whatever the compiler's contraction flags say. That is what
 * the C++ helper computes when -march=native lets its compiler fuse the
 * multiply and the subtract.
 *
 * Built with the system C compiler at first use (data/native.py). Returns
 * 0, or 1 when the counts cannot be allocated. */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

int bdm_build_blending_indices(const double *weights, int64_t n_datasets,
                               int64_t size, int32_t *dataset_index,
                               int64_t *dataset_sample_index)
{
    int64_t *counts = calloc((size_t)(n_datasets > 0 ? n_datasets : 1),
                             sizeof(int64_t));
    if (counts == NULL)
        return 1;
    for (int64_t i = 0; i < size; ++i) {
        const double target = (double)(i + 1);
        double best_err = -1e300;
        int64_t best = 0;
        for (int64_t j = 0; j < n_datasets; ++j) {
            const double err = fma(weights[j], target, -(double)counts[j]);
            if (err > best_err) {
                best_err = err;
                best = j;
            }
        }
        dataset_index[i] = (int32_t)best;
        dataset_sample_index[i] = counts[best];
        ++counts[best];
    }
    free(counts);
    return 0;
}
