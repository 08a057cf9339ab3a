/* Jonker-Volgenant shortest-augmenting-path LAP solver.
 *
 * Host-side analog of raft::solver::LinearAssignmentProblem
 * (solver/linear_assignment.cuh, the Date-Nagi GPU Hungarian variant): the
 * assignment problems its consumers solve (cluster matching, tracking) are
 * O(n^3) host work at build or evaluation time. This file is the port's own
 * copy of the JAX package's solver; raft_tpu_torch/native/build.py compiles
 * it with the system C compiler at first use and binds it through ctypes.
 *
 * Input: n x n row-major cost matrix. Output: p[j] = row assigned to
 * column j (0-based). Returns 0 on success, -1 when an allocation fails.
 */
#include <stdlib.h>

int lap_jv(const double *c, long n, long *p_out) {
    /* 1-indexed arrays, potentials u (rows) / v (cols). */
    double *u = (double *)calloc((size_t)(n + 1), sizeof(double));
    double *v = (double *)calloc((size_t)(n + 1), sizeof(double));
    double *minv = (double *)malloc((size_t)(n + 1) * sizeof(double));
    long *p = (long *)calloc((size_t)(n + 1), sizeof(long)); /* col -> row */
    long *way = (long *)calloc((size_t)(n + 1), sizeof(long));
    char *used = (char *)malloc((size_t)(n + 1));
    if (!u || !v || !minv || !p || !way || !used) {
        free(u); free(v); free(minv); free(p); free(way); free(used);
        return -1;
    }
    const double INF = 1e300;

    for (long i = 1; i <= n; ++i) {
        p[0] = i;
        long j0 = 0;
        for (long j = 0; j <= n; ++j) { minv[j] = INF; used[j] = 0; }
        do {
            used[j0] = 1;
            long i0 = p[j0];
            double delta = INF;
            long j1 = 0;
            const double *row = c + (i0 - 1) * n;
            double ui0 = u[i0];
            for (long j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = row[j - 1] - ui0 - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (long j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else { minv[j] -= delta; }
            }
            j0 = j1;
        } while (p[j0] != 0);
        /* augment along the alternating path */
        do {
            long j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }

    for (long j = 1; j <= n; ++j) p_out[j - 1] = p[j] - 1;
    free(u); free(v); free(minv); free(p); free(way); free(used);
    return 0;
}
