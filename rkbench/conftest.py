"""Fixtures of the benchmark's tests: tiny configurations that run on the
CPU in seconds."""
import pytest
import torch

from rkbench import manifest

TINY = {"n_users": 3000, "n_items": 500, "d": 16, "tau": 64, "omega": 4,
        "s": 16}
TINY_TRAFFIC = {"pool_batches": 64, "warmup_batches": 2, "check_batches": 8,
                "trace_batches": 8}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(cell_name: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell, configuration, traffic) of a cell at a tiny size:
    its configuration's storage, backend, reference, control and limits,
    its mix's parameters, on a few thousand users."""
    man = manifest.load_manifest()
    cell = manifest.workload(man, cell_name)
    cfg = dict(manifest.config(cell["config"]), **TINY)
    traffic = dict(manifest.traffic(cell["traffic"]), **TINY_TRAFFIC)
    return man, cell, cfg, traffic

