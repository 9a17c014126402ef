"""Launchers of the port: the serving entry point (`launch.serve`, run as
`python -m repro_torch.launch.serve`), the training launcher
(`launch.train`), the production mesh (`launch.mesh`), the dry run over
the (architecture x input shape x mesh) cells (`launch.dryrun`) with its
three-term roofline (`launch.roofline`), and the roofline table
(`launch.roofline_report`)."""
