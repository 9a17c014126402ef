"""Paper-engine configurations: rank-table parameters and the paper's
dataset scales (§5), used by the serving driver, the examples and
`chip_smoke.py`. A copy of the reference's table, on the port's
`RankTableConfig`."""
import dataclasses

from repro_torch.core.types import RankTableConfig

# Paper defaults after the Table-1 tuning (τ = 500).
DEFAULT_TABLE = RankTableConfig(tau=500, omega=10, s=64)


@dataclasses.dataclass(frozen=True)
class DatasetScale:
    name: str
    n_users: int
    n_items: int
    d: int = 200            # the paper's MF embedding dimensionality


# Exact §5 dataset sizes.
AMAZON_K = DatasetScale("amazon-k", 1_406_890, 430_530)
MOVIELENS = DatasetScale("movielens", 162_541, 59_047)
NETFLIX = DatasetScale("netflix", 480_189, 17_770)
DATASETS = {d.name: d for d in (AMAZON_K, MOVIELENS, NETFLIX)}

# §5 protocol: 1000 random item queries; k and c sweeps from Figs. 3-4.
N_QUERIES = 1000
K_SWEEP = (10, 20, 30, 40, 50)
C_SWEEP = (1.5, 2.0, 2.5, 3.0)
