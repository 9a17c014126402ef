"""Training of the LM substrate: AdamW and its schedule (`optimizer`),
the train step with microbatches (`trainer`) and atomic checkpoints in
the reference's layout (`checkpoint`). Counterpart of the reference's
`repro/train/`, on one device."""
