"""The paper's examples on the port, each a `main(*, device=None,
**sizes)` whose sizes default to the reference example's, run as
`python -m repro_torch.examples.<name>` (on the CUDA card):

  quickstart      — build a rank-table index, answer one query, grade it
                    against the exact oracle;
  ablation        — what each piece of Algorithm 1 buys (ω, s, threshold
                    mode);
  serve_retrieval — ratings → MF embeddings → a `cached:dense` index →
                    a MicroBatcher burst → §5 grading, then step 4:
                    backbone-encoded embeddings;
  train_lm        — train a ~79 M-parameter dense LM for 200 steps with
                    checkpoints (`main(*, device=None, tiny=False,
                    steps=None)`).
"""
