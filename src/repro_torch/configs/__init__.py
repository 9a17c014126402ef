"""Configurations of the port.

`paper_engine` holds the paper's rank-table defaults and its §5 dataset
scales (a copy of the reference's module). The reference's package also
holds the architecture registry of the LM substrate (`get_config`,
`reduced`); that comes with the substrate's port, ROADMAP queue 1 item
14, and this package has none yet.
"""
