"""Port types (`repro_torch.core.types`) against the JAX reference."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import QueryResult as RefQueryResult
from repro.core.types import RankTable as RefRankTable
from repro.core.types import RankTableConfig as RefConfig
from repro.core.types import kth_smallest as ref_kth_smallest
from repro.core.types import partition_sizes as ref_partition_sizes
from repro_torch.core.types import QueryResult, RankTable, RankTableConfig, \
    kth_smallest, partition_sizes


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so torch does not starve the timing-sensitive
    tests that share the run."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_config_fields_and_defaults_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(RankTableConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    assert ours == theirs


@pytest.mark.parametrize("kwargs", [
    dict(tau=1), dict(omega=0), dict(s=0), dict(threshold_mode="bogus"),
    dict(storage_dtype="float16")])
def test_config_rejects_what_reference_rejects(kwargs):
    with pytest.raises(ValueError):
        RefConfig(**kwargs)
    with pytest.raises(ValueError):
        RankTableConfig(**kwargs)


@pytest.mark.parametrize("spec", ["bf16", "bfloat16", "int8"])
def test_quantized_storage_kind_matches_reference(spec):
    assert RankTableConfig(storage_dtype=spec).storage.kind == \
        RefConfig(storage_dtype=spec).storage.kind


@pytest.mark.parametrize("kwargs", [
    dict(), dict(tau=2, omega=1, s=1), dict(threshold_mode="exact"),
    dict(threshold_mode="norm_bound", storage_dtype="f32")])
def test_config_accepts_what_reference_accepts(kwargs):
    assert dataclasses.asdict(RankTableConfig(**kwargs)) == \
        dataclasses.asdict(RefConfig(**kwargs))


def test_result_and_table_fields_match_reference():
    assert QueryResult._fields == RefQueryResult._fields
    assert RankTable._fields == RefRankTable._fields


@pytest.mark.parametrize("shape,k", [((50,), 1), ((50,), 7), ((3, 40), 5),
                                     ((16, 33), 33)])
@pytest.mark.parametrize("seed", [0, 1])
def test_kth_smallest_matches_reference(shape, k, seed):
    # integer-valued data: repeated values exercise the order statistic
    x = np.random.default_rng(seed).integers(-5, 5, shape).astype(np.float32)
    np.testing.assert_array_equal(
        kth_smallest(torch.from_numpy(x), k).numpy(),
        np.asarray(ref_kth_smallest(jnp.asarray(x), k)))


@pytest.mark.parametrize("m,omega", [(10, 10), (17_770, 10), (1023, 7),
                                     (5, 1)])
def test_partition_sizes_match_reference(m, omega):
    assert partition_sizes(m, omega) == ref_partition_sizes(m, omega)
