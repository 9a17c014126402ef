"""The paper's examples on the port, each a `main(*, device=None,
**sizes)` whose sizes default to the reference example's, run as
`python -m repro_torch.examples.<name>` (on the CUDA card):

  quickstart      — build a rank-table index, answer one query, grade it
                    against the exact oracle;
  ablation        — what each piece of Algorithm 1 buys (ω, s, threshold
                    mode);
  serve_retrieval — ratings → MF embeddings → a `cached:dense` index →
                    a MicroBatcher burst → §5 grading (steps 1-3 of the
                    reference's example; its step 4, backbone-encoded
                    embeddings, waits for the LM substrate's port).
"""
