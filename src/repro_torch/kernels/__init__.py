"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  user_scores — K1: fused U·Qᵀ + rank-table bucketize (§4.3 step 1)
  table_build — K2: fused U·Samplesᵀ + Eq. (1) weighted counts
  exact_rank  — K3: streaming Definition-1 counts (exact oracle)

`ops.py` holds the public wrappers: a CPU tensor takes the plain
version in `ref.py`, a CUDA tensor launches the kernel or raises.
`user_scores.py`, `table_build.py` and `exact_rank.py` launch one kernel
each; `_build.py` compiles `csrc/*.cu` with nvcc at first CUDA use.
"""
