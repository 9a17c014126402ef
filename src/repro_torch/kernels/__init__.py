"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  user_scores — K1: fused U·Qᵀ + rank-table bucketize (§4.3 step 1)
  user_scores_quant — K4 / K5: the same on a bf16 / int8 table, with
                the certified widening of the storage tier
  table_build — K2: fused U·Samplesᵀ + Eq. (1) weighted counts
  exact_rank  — K3: streaming Definition-1 counts (exact oracle)
  select_topk — the selection (§4.3 steps 2-3): R↓_k / R↑_k, then the
                Lemma-1 key's k smallest users, over step 1's bounds

`ops.py` holds the public wrappers: a CPU tensor takes the plain
version (in `ref.py`; the selection's is `core.query.select_topk_plain`),
a CUDA tensor launches the kernel or raises. `user_scores.py` launches
K1, K4 and K5, `table_build.py`, `exact_rank.py` and `select_topk.py`
their own kernels; `_build.py` compiles `csrc/*.cu` with nvcc at first
CUDA use.
"""
