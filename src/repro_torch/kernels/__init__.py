"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  user_scores — K1: fused U·Qᵀ + rank-table bucketize (§4.3 step 1)
  user_scores_quant — K4 / K5: the same on a bf16 / int8 table, with
                the certified widening of the storage tier
  table_build — K2: fused U·Samplesᵀ + Eq. (1) weighted counts
  exact_rank  — K3: streaming Definition-1 counts (exact oracle)

`ops.py` holds the public wrappers: a CPU tensor takes the plain
version in `ref.py`, a CUDA tensor launches the kernel or raises.
`user_scores.py` launches K1, K4 and K5, `table_build.py` and
`exact_rank.py` one kernel each; `_build.py` compiles `csrc/*.cu` with
nvcc at first CUDA use.
"""
