"""The port's architecture registry (`repro_torch.configs`) and model
configuration (`repro_torch.models.config`) against the reference's:
the same ids, every published config field for field, the same
`reduced()` shrink, segments and shape cells; `reduced_depth` keeps the
published widths at `reduced()`'s layer counts."""
import dataclasses

import pytest
import torch

from repro import configs as ref_configs
from repro.models import config as ref_config
from repro_torch import configs
from repro_torch.models import config


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_arch_ids_are_the_references():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS


def test_config_fields_are_the_references():
    names = lambda cls: [(f.name, f.default) for f in
                         dataclasses.fields(cls)]
    assert names(config.ModelConfig) == names(ref_config.ModelConfig)
    assert names(config.ShapeCell) == names(ref_config.ShapeCell)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_published_config_is_the_references(arch):
    got, want = configs.get_config(arch), ref_configs.get_config(arch)
    assert isinstance(got, config.ModelConfig)
    assert _fields(got) == _fields(want)
    assert got.dtype == "bfloat16"
    assert (got.hd, got.q_dim, got.kv_dim, got.lru_width) == \
        (want.hd, want.q_dim, want.kv_dim, want.lru_width)
    assert got.segments() == want.segments()
    assert got.enc_segments() == want.enc_segments()


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_reduced_is_the_references(arch):
    for layers in (2, 5):
        got = configs.reduced(configs.get_config(arch), layers=layers)
        want = ref_configs.reduced(ref_configs.get_config(arch),
                                   layers=layers)
        assert _fields(got) == _fields(want)
        assert got.segments() == want.segments()


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_reduced_depth_keeps_the_published_widths(arch):
    full = configs.get_config(arch)
    cut = configs.reduced_depth(full)
    small = configs.reduced(full)
    assert cut.n_layers == small.n_layers
    assert cut.n_enc_layers == (small.n_enc_layers
                                if full.family == "encdec"
                                else full.n_enc_layers)
    changed = {k for k, v in _fields(cut).items() if _fields(full)[k] != v}
    assert changed <= {"n_layers", "n_enc_layers"}
    assert sum(len(p) * r for p, r in cut.segments()) == cut.n_layers


def test_shape_cells_and_applicability_are_the_references():
    assert [dataclasses.astuple(c) for c in config.SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in ref_config.SHAPE_CELLS]
    for arch in ref_configs.ARCH_IDS:
        for got_cell, want_cell in zip(config.SHAPE_CELLS,
                                       ref_config.SHAPE_CELLS):
            assert got_cell.is_decode == want_cell.is_decode
            assert config.cell_applicable(configs.get_config(arch),
                                          got_cell) == \
                ref_config.cell_applicable(ref_configs.get_config(arch),
                                           want_cell)


def test_bad_configs_raise_as_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")
    for kw in (dict(family="transformer"), dict(family="moe"),
               dict(family="hybrid")):
        with pytest.raises(ValueError):
            config.ModelConfig(name="x", n_layers=1, d_model=8, n_heads=1,
                               n_kv_heads=1, d_ff=8, vocab=8, **kw)
