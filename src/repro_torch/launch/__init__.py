"""Launchers of the port: the serving entry point (`launch.serve`, run as
`python -m repro_torch.launch.serve`) and the training launcher
(`launch.train`, `python -m repro_torch.launch.train`). The reference's
multi-pod dry-run, mesh and roofline launchers come with the port's
sharding (ROADMAP queue 1 item 14)."""
