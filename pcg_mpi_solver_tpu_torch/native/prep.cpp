// Native prep kernels of pcg_mpi_solver_tpu_torch: a copy of the JAX
// package's native/src/prep.cpp, the partitioner's per-element hot loops.
//
// The reference left these loops in pure Python with explicit
// `TODO: Perform the element loop in Cython` markers (reference:
// src/solver/partition_mesh.py:244,271,280,1170).  Here they are native:
//
//   * pcgn_csr_take       — ragged gather flat[offset[e]:offset[e+1]] for a
//                           list of elements (config_ElemVectors gather,
//                           partition_mesh.py:245-255),
//   * pcgn_unique_renumber— sorted-unique of global ids + local renumbering
//                           (the np.unique + getIndices pattern,
//                           partition_mesh.py:272-286),
//   * pcgn_sort_i32       — stable index argsort of the flat scatter map.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

using i64 = int64_t;
using i32 = int32_t;

extern "C" {

// out must hold sum(offset[e+1]-offset[e] for e in elems) entries.
// Returns the number of values written.
i64 pcgn_csr_take(const i64* flat, const i64* offset, const i64* elems,
                  i64 n_elems, i64* out) {
  i64 k = 0;
  for (i64 i = 0; i < n_elems; ++i) {
    const i64 e = elems[i];
    for (i64 j = offset[e]; j < offset[e + 1]; ++j) out[k++] = flat[j];
  }
  return k;
}

// Sorted unique of ids[0..n) into uniq (capacity n) and, when loc is
// non-null, the local index of every input id into loc (int32).
// Returns the unique count.
i64 pcgn_unique_renumber(const i64* ids, i64 n, i64* uniq, i32* loc) {
  if (n == 0) return 0;
  std::vector<i64> sorted(ids, ids + n);
  std::sort(sorted.begin(), sorted.end());
  i64 nu = 0;
  i64 prev = sorted[0] - 1;
  for (i64 i = 0; i < n; ++i) {
    if (sorted[i] != prev) { prev = sorted[i]; uniq[nu++] = prev; }
  }
  if (loc) {
    for (i64 i = 0; i < n; ++i) {
      const i64* p = std::lower_bound(uniq, uniq + nu, ids[i]);
      loc[i] = (i32)(p - uniq);
    }
  }
  return nu;
}

// Stable argsort of int32 keys; perm must hold n entries, sorted_keys n.
void pcgn_sort_i32(const i32* keys, i64 n, i32* perm, i32* sorted_keys) {
  std::vector<i32> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(),
                   [&](i32 a, i32 b) { return keys[a] < keys[b]; });
  for (i64 i = 0; i < n; ++i) {
    perm[i] = idx[i];
    sorted_keys[i] = keys[idx[i]];
  }
}

}  // extern "C"
