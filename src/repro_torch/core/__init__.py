"""The port's core: types, Algorithm 1, the §4.3 query, the exact oracle,
the §5 metrics, the backend registry and the engine. Import the
submodules directly (`from repro_torch.core.query import ...`)."""
