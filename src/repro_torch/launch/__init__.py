"""Launchers of the port: the serving driver (`launch.serve`, run as
`python -m repro_torch.launch.serve`). The reference's training driver,
multi-pod dry-run, mesh and roofline launchers belong to the LM
substrate and come with its port (ROADMAP queue 1 item 14)."""
