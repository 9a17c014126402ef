"""The port's checkpoints (`repro_torch.train.checkpoint`) on the CPU: the
reference's cases from tests/test_checkpoint.py run on the port
(roundtrip with metadata, the LATEST pointer and pruning, a given step,
shape mismatch → ValueError, a missing leaf → KeyError, a torn writer
and a torn pointer invisible, an empty directory), then each package's
`restore` reading the other's checkpoint of a train state (parameters and
AdamW state of a reduced model), bitwise, with the same keys on disk.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.model import Model as RefModel
from repro.train import checkpoint as ref_ckpt
from repro.train.optimizer import OptState as RefOptState
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch import configs, convert
from repro_torch.models.model import Model
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptState, adamw_init


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": [torch.ones((2,)), torch.zeros((3, 3))]},
            "scalar": torch.tensor(3, dtype=torch.int32)}


def _template(tree):
    return T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), tree)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, metadata={"note": "x"})
    restored, step, meta = ckpt.restore(str(tmp_path), _template(t),
                                        device="cpu")
    assert step == 7 and meta == {"note": "x"}
    for a, b in zip(T.leaves(t), T.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_pointer_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 5
    ckpt.prune_old(str(tmp_path), keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    _, step, _ = ckpt.restore(str(tmp_path), _template(t), device="cpu")
    assert step == 5


def test_restore_specific_step(tmp_path):
    ckpt.save(str(tmp_path), 1, {"v": torch.tensor(1.0)})
    ckpt.save(str(tmp_path), 2, {"v": torch.tensor(2.0)})
    restored, step, _ = ckpt.restore(
        str(tmp_path), {"v": torch.tensor(0.0)}, step=1, device="cpu")
    assert step == 1 and float(restored["v"]) == 1.0


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"v": torch.ones((4,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"v": torch.ones((5,))}, device="cpu")


def test_missing_leaf_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"v": torch.ones((4,))})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"v": torch.ones((4,)),
                                     "w": torch.ones((1,))}, device="cpu")


def test_torn_writer_leaves_no_partial_step(tmp_path):
    """A crashed writer (a leftover tmp dir) and a pointer to a step that
    never landed are invisible to readers."""
    ckpt.save(str(tmp_path), 1, {"v": torch.tensor(1.0)})
    os.makedirs(tmp_path / ".tmp_step_9_dead")      # torn write remains
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step, _ = ckpt.restore(str(tmp_path), {"v": torch.tensor(0.0)},
                              device="cpu")
    assert step == 1
    (tmp_path / "LATEST").write_text("step_00000009")  # torn pointer
    assert ckpt.latest_step(str(tmp_path)) is None


def test_empty_dir(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"v": torch.tensor(0.0)}, device="cpu")


def test_restore_needs_a_device_or_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ckpt.save(str(tmp_path), 1, {"v": torch.tensor(1.0)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(str(tmp_path), {"v": torch.tensor(0.0)})


# ------------------------------------------------------ across the packages
ARCH = "gemma-2b"


def _ref_state():
    cfg = ref_configs.reduced(ref_configs.get_config(ARCH))
    model = RefModel(cfg)
    params = model.init_params(jax.random.PRNGKey(4))
    # moments and step that are not zeros
    opt = RefOptState(mu=jax.tree.map(lambda p: p * 0.5, params),
                      nu=jax.tree.map(lambda p: p * p, params),
                      step=jax.numpy.asarray(3, jax.numpy.int32))
    return model, {"params": params, "opt": opt}


def _flat_np(tree):
    """{key on disk: numpy array} of a reference or port tree."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in ckpt._paths(tree)}


def test_port_reads_the_references_train_state(tmp_path):
    ref_model, state = _ref_state()
    ref_ckpt.save(str(tmp_path), 3, state, metadata={"from": "reference"})
    model = Model(configs.reduced(configs.get_config(ARCH)))
    tpl = {"params": model.abstract_params(),
           "opt": adamw_init(model.abstract_params())}
    got, step, meta = ckpt.restore(str(tmp_path), tpl, device="cpu")
    assert step == 3 and meta == {"from": "reference"}
    assert isinstance(got["opt"], OptState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 3
    want = _flat_np(state)
    have = _flat_np(got)
    assert set(have) == set(want)
    for k, v in want.items():
        assert have[k].dtype == v.dtype and np.array_equal(have[k], v), k
    # and it equals the converted state
    conv = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, state["opt"]), model.cfg, device="cpu")
    have = _flat_np(got["opt"])
    for k, v in _flat_np(conv).items():
        assert np.array_equal(have[k], v), k


def test_reference_reads_the_ports_train_state(tmp_path):
    model = Model(configs.reduced(configs.get_config(ARCH)))
    params = model.init_params(5, device="cpu")
    opt = OptState(mu=T.tree_map(lambda p: p * 0.5, params),
                   nu=T.tree_map(lambda p: p * p, params),
                   step=torch.tensor(3, dtype=torch.int32))
    state = {"params": params, "opt": opt}
    ckpt.save(str(tmp_path), 3, state, metadata={"from": "port"})
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json"
                           ).read_text())
    assert "params/segments/0/b0/attn/wq" in manifest["keys"]
    assert "opt/.mu/embed/tok" in manifest["keys"]
    assert "opt/.step" in manifest["keys"]
    ref_model = RefModel(ref_configs.reduced(ref_configs.get_config(ARCH)))
    tpl = {"params": ref_model.abstract_params(),
           "opt": jax.eval_shape(ref_adamw_init,
                                 ref_model.abstract_params())}
    got, step, meta = ref_ckpt.restore(str(tmp_path), tpl)
    assert step == 3 and meta == {"from": "port"}
    want = _flat_np(state)
    have = _flat_np(got)
    assert set(have) == set(want)
    for k, v in want.items():
        assert have[k].dtype == v.dtype and np.array_equal(have[k], v), k
