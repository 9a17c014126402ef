"""`correct` holds for the program and fails for the control and for each
fault, in a whole run at a tiny size on the CPU (the program's plain
path), the look for a card left out. The control is the reference in the
configuration's lower precision put in the program's place: TF32
operands where the configuration states f32, int4 codes where it states
int8."""
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from rkbench import harness, inputs, loadgen, manifest
from rkbench.conftest import tiny

CELLS = ["netflix-f32.uniform-b16", "amazon-k-int8.uniform-b16"]
SEED = 2**31 + 101


def _run(cell_name, monkeypatch=None, program=None):
    """A whole run on the CPU; `program(state, cfg, traffic)` replaces the
    timed path that set-up made."""
    man, cell, cfg, traffic = tiny(cell_name)
    if program is not None:
        setup = harness.setup

        def patched(*args, **kw):
            state = setup(*args, **kw)
            state["program"] = program(state, cfg, traffic)
            return state
        monkeypatch.setattr(harness, "setup", patched)
    return harness.run(man, cell, cfg, traffic, SEED, 0.3, False,
                       time.perf_counter(), "cpu", log=lambda o: None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, monkeypatch):
    def control(state, cfg, traffic):
        low = harness.reference_for(cfg, state["data"], cfg["control"])
        return harness.reference_program(low, traffic["k"], traffic["c"])

    res = _run(cell, monkeypatch, control)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["stale", "half_batch", "answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(cell, fault, monkeypatch):
    res = _run(cell, monkeypatch,
               lambda state, cfg, traffic: harness.faulty(
                   state["program"], fault, cfg["n_users"]))
    assert not res["correct"], res["checks"]


def test_run_refuses_without_a_card():
    """No card: a non-zero exit and no result line, never a CPU number."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "rkbench" / "run.py"), "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def _class1_off_by_one(ref, qs, k, c, m):
    """The reference's answer with its k-th user swapped for its (k+1)-th
    in each query whose k-th user is of Lemma-1 class 1 (a query that is
    not guaranteed): a selection fault inside class 1. Returns the
    answer and the number of queries changed."""
    key, est = ref.keys(qs, c, k)
    order = torch.sort(key, dim=1, stable=True).indices
    idx = order[:, :k].clone()
    cls1 = (key.gather(1, order[:, k - 1:k]) >= m + 2).squeeze(1) \
        & (key.gather(1, order[:, k - 1:k]) < 2 * (m + 2)).squeeze(1)
    idx[cls1, k - 1] = order[cls1, k]
    return (idx, torch.gather(est, 1, idx)), int(cls1.sum())


@pytest.mark.parametrize("cell", CELLS)
def test_a_class1_off_by_one_is_caught(cell):
    """Returning the (k+1)-th user for the k-th inside class 1 fails
    `pick_off_share`: its tolerance is on the estimate, not on the
    composite key class·(m + 2) + est, which is m + 2 larger there."""
    _, _, cfg, traffic = tiny(cell)
    data = inputs.make(cfg, SEED, "cpu")
    state = {"qv": loadgen.query_pool(traffic, data, SEED)}
    ref = harness.reference_for(cfg, data)
    k, c, m = traffic["k"], traffic["c"], cfg["n_items"]
    planted, exact, changed = [], [], 0
    for qs in state["qv"]:
        answer, n = _class1_off_by_one(ref, qs, k, c, m)
        planted.append(answer)
        exact.append(ref.query(qs, k, c))
        changed += n
    assert changed > 0, "no query with its k-th user in class 1"
    batches = list(range(state["qv"].shape[0]))
    compare = manifest.reference(cfg["reference"]).compare
    good = compare(ref, state, {"answers": exact}, batches, traffic)
    bad = compare(ref, state, {"answers": planted}, batches, traffic)
    assert good["pick_off"] == 0 and good["est_off"] == 0
    assert bad["pick_off_share"] > cfg["correct"]["pick_off_share"], bad
    assert bad["est_off"] == 0
