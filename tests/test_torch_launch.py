"""The port's serving driver (`repro_torch.launch.serve`) on the CPU.

  * its parser has every option of the reference's parser (same option
    strings, defaults, types, choices and actions) plus `--device`;
  * the slice as a whole: the serving steps of the driver (build,
    MicroBatcher burst, grading by the exact oracle and the §5 metrics)
    on both packages, fed the same users, items, build samples and query
    ids, on `dense` and `fused`: the served selections are equal as sets
    (up to ties) and the accuracies and overall ratios equal to 1e-6;
  * the CLI as a user runs it, in subprocesses under the import blocker
    of tests/test_torch_imports.py (`chip_smoke.run_blocked`), with
    `--device cpu` at n = 2,048, m = 800, d = 32, τ = 32: plain; churn
    with persistence and the auditor, then `restore`; SIGTERM, then exit 0
    and `restore`; `--metrics-port 0` scraped, then SIGINT; `--mf`;
    `--backend sharded`; and without `--device` on a machine with no
    card, which must exit non-zero.

The paper-engine configuration is held field by field against the
reference's module, read from its file (importing `repro.configs` pulls
in the LM substrate).

Hygiene: two intra-op threads; every subprocess wait is bounded and every
process is killed in `finally`.
"""
import argparse
import importlib.util
import json
import re
import signal
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.engine import ReverseKRanksEngine as RefEngine
from repro.core.exact import exact_ranks as ref_exact_ranks
from repro.core.rank_table import stratified_sample_indices
from repro.core.types import RankTableConfig as RefConfig
from repro.data.pipeline import synthetic_embeddings as ref_synthetic
from repro.serve import MicroBatcher as RefMicroBatcher
from repro_torch.configs import paper_engine
from repro_torch.convert import from_reference
from repro_torch.core.engine import ReverseKRanksEngine
from repro_torch.core.exact import exact_ranks
from repro_torch.launch import serve as serve_mod

ROOT = Path(__file__).resolve().parents[1]
N, M, D, TAU = 2048, 800, 32, 32
K, C = 10, 2.0
SMALL = ["--n", str(N), "--m", str(M), "--d", str(D), "--tau", str(TAU)]
TIMEOUT = 180


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------------ parser
class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's `main()` builds, caught at its
    `parse_args` call."""
    import repro.launch.serve as ref_serve
    seen = {}

    def grab(self, *a, **kw):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        ref_serve.main()
    monkeypatch.undo()
    return seen["parser"]


def _options(parser) -> dict:
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_parser_has_every_reference_option(monkeypatch):
    ref = _options(_reference_parser(monkeypatch))
    ours = _options(serve_mod.build_parser())
    assert set(ours) == set(ref) | {"--device"}
    for name, a in ref.items():
        b = ours[name]
        assert b.option_strings == a.option_strings, name
        assert type(b) is type(a), name
        assert (b.default, b.type, b.choices, b.nargs, b.dest) == (
            a.default, a.type, a.choices, a.nargs, a.dest), name
    assert ours["--device"].default is None


def test_kernels_alias_selects_fused_alone(capsys):
    with pytest.raises(SystemExit) as e:
        serve_mod.main(["--kernels", "--backend", "fused", "--device",
                        "cpu"])
    assert e.value.code == 2
    assert "deprecated alias for --backend fused" in capsys.readouterr().err
    args = serve_mod.build_parser().parse_args(
        ["--kernels", "--n", "64", "--m", "40", "--d", "8", "--tau", "8",
         "--device", "cpu"])
    users, items = serve_mod.build_embeddings(args)
    assert serve_mod.build_engine(args, users, items).backend_name == "fused"


def test_paper_engine_is_the_references():
    path = ROOT / "src" / "repro" / "configs" / "paper_engine.py"
    spec = importlib.util.spec_from_file_location("_ref_paper_engine", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for name in ("AMAZON_K", "MOVIELENS", "NETFLIX"):
        a, b = getattr(ref, name), getattr(paper_engine, name)
        assert (b.name, b.n_users, b.n_items, b.d) == (a.name, a.n_users,
                                                       a.n_items, a.d)
    assert {k: (v.n_users, v.n_items, v.d)
            for k, v in paper_engine.DATASETS.items()} == {
        k: (v.n_users, v.n_items, v.d) for k, v in ref.DATASETS.items()}
    for f in ("tau", "omega", "s", "threshold_mode", "range_pad",
              "sample_with_replacement", "storage_dtype"):
        assert getattr(paper_engine.DEFAULT_TABLE, f) == getattr(
            ref.DEFAULT_TABLE, f), f
    assert (paper_engine.N_QUERIES, paper_engine.K_SWEEP,
            paper_engine.C_SWEEP) == (ref.N_QUERIES, ref.K_SWEEP,
                                      ref.C_SWEEP)


# ------------------------------------------------------- the slice, whole
Q, MAX_BATCH = 24, 8


@pytest.fixture(scope="module")
def ref_inputs():
    users, items = ref_synthetic(jax.random.PRNGKey(0), N, M, D)
    qidx = np.array(jax.random.randint(jax.random.PRNGKey(2), (Q,), 0, M))
    cfg = RefConfig(tau=TAU)
    pos, w = stratified_sample_indices(jax.random.PRNGKey(1), M, cfg)
    return dict(users=users, items=items, qidx=qidx, cfg=cfg, pos=pos, w=w)


def _reference_serving(r, backend):
    """The reference driver's serving steps (repro/launch/serve.py:main):
    build with key 1, warm-up, one MicroBatcher burst; returns each
    query's selection and the reference oracle's ranks of the first 20."""
    eng = RefEngine.build(r["users"], r["items"], r["cfg"],
                          jax.random.PRNGKey(1), backend=backend)
    qs = r["items"][r["qidx"]]
    eng.query_batch(qs[:MAX_BATCH], k=K, c=C)
    with RefMicroBatcher(eng, max_batch=MAX_BATCH, max_wait_ms=2.0) as mb:
        futs = [mb.submit(q, K, C) for q in qs]
        results = [f.result(timeout=TIMEOUT) for f in futs]
    truth = [np.asarray(ref_exact_ranks(r["users"], r["items"], qs[i]))
             for i in range(20)]
    return [np.asarray(x.indices) for x in results], truth


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_serving_steps_match_reference(ref_inputs, backend, capsys):
    """Equal selections; and the port's grading of its selections equals
    the reference's §5 metrics of the reference's selections given the
    same true ranks, the port oracle's. The two oracles agree to one
    rank: the reference may count q, an item here, against itself, and a
    score within rounding of u·q may fall either side of it; one rank
    moves a ratio, so the reference's own oracle is held to that."""
    r = ref_inputs
    want_idx, ref_truth = _reference_serving(r, backend)
    args = serve_mod.build_parser().parse_args(
        SMALL + ["--backend", backend, "--queries", str(Q), "--max-batch",
                 str(MAX_BATCH), "--device", "cpu"])
    st = from_reference(users=r["users"], items=r["items"],
                        positions=r["pos"], weights=r["w"], device="cpu")
    eng = serve_mod.build_engine(args, st.users, st.items,
                                 positions=st.positions, weights=st.weights)
    qs = st.items[torch.from_numpy(r["qidx"]).long()]
    results, stopped = serve_mod.serve(args, eng, qs)
    accs, ratios = serve_mod.evaluate(args, eng, st.users, st.items, qs,
                                      results)
    assert not stopped
    assert [i for i, _ in results] == list(range(Q))
    for (_, res), want in zip(results, want_idx):
        assert res.indices.device.type == "cpu"
        assert set(res.indices.tolist()) == set(want.tolist())
    want_acc, want_ratio = [], []
    for i in range(20):
        truth = exact_ranks(st.users, st.items, qs[i]).numpy()
        assert np.all(np.abs(ref_truth[i] - truth) <= 1)
        ex_idx = np.argsort(truth, kind="stable")[:K]
        want_acc.append(ref_metrics.accuracy(want_idx[i], ex_idx, truth, C))
        want_ratio.append(ref_metrics.overall_ratio(want_idx[i], ex_idx,
                                                    truth))
    np.testing.assert_allclose(accs, want_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ratios, want_ratio, rtol=0, atol=1e-6)
    out = capsys.readouterr().out
    for head in ("build:", "serve:", "  ticks:", "accuracy "):
        assert any(ln.startswith(head) for ln in out.splitlines()), head


# ------------------------------------------------------------ the CLI runs
def _cli(*flags, timeout=TIMEOUT, popen=False):
    import chip_smoke
    return chip_smoke.run_blocked("repro_torch.launch.serve", *flags,
                                  timeout=timeout, popen=popen)


def _ok(out) -> str:
    assert out.returncode == 0, out.stderr[-4000:]
    import chip_smoke
    assert chip_smoke.runner_report(out.stdout)["leaked"] == []
    return out.stdout


def _accuracy(stdout: str) -> tuple:
    m = re.search(r"^accuracy (\S+)  overall-ratio (\S+)", stdout, re.M)
    assert m, stdout[-2000:]
    acc, ratio = float(m.group(1)), float(m.group(2))
    assert 0.0 <= acc <= 1.0 and np.isfinite(ratio) and ratio >= 1.0
    return acc, ratio


def test_cli_serves_and_grades():
    out = _ok(_cli(*SMALL, "--queries", "32", "--max-batch", "8",
                   "--backend", "fused", "--device", "cpu"))
    m = re.search(r"^build: \S+s  index (\S+) MiB", out, re.M)
    assert m and abs(float(m.group(1)) - N * (TAU * 8 + D * 4) / 2**20) < 0.1
    assert re.search(r"^serve: \S+ ms/query wall \(fused backend", out, re.M)
    assert re.search(r"^  ticks: 32 reqs", out, re.M)
    _accuracy(out)


def test_cli_update_stream_persists_and_restores(tmp_path):
    queries, every = 64, 8
    out = _ok(_cli(*SMALL, "--queries", str(queries), "--max-batch", "8",
                   "--backend", "elastic:fused", "--storage", "int8",
                   "--update-stream", "--update-every", str(every),
                   "--rebuild-delta-ratio", "0.02", "--persist-dir",
                   str(tmp_path), "--audit-fraction", "0.25",
                   "--stats-every", "16", "--device", "cpu"))
    m = re.search(r"update stream: final epoch (\d+), (\d+) rebuild", out)
    assert m and int(m.group(2)) >= 1, out[-2000:]
    assert re.search(r"^    rebuild \d+->\d+ \[.*\] build \S+s swap", out,
                     re.M)
    m_audit = re.search(r"audit: (\d+) scored", out)
    assert m_audit and int(m_audit.group(1)) >= 1
    _accuracy(out)
    eng = ReverseKRanksEngine.restore(tmp_path, backend="fused",
                                      device="cpu")
    batches = (queries - 1) // every
    assert eng.live_item_ids().size == M + (8 - 4) * batches
    assert eng.epoch == int(m.group(1))


def _lines(*flags):
    import chip_smoke
    return chip_smoke.Lines(_cli(*flags, popen=True))


def test_cli_sigterm_drains_spills_and_exits_0(tmp_path):
    lines = _lines(*SMALL, "--queries", "200000", "--max-batch", "8",
                   "--update-stream", "--persist-dir", str(tmp_path),
                   "--stats-every", "64", "--drain-s", "2", "--device",
                   "cpu")
    try:
        lines.wait_for(r"^  \[64/", TIMEOUT)
        lines.proc.send_signal(signal.SIGTERM)
        rc, out, err = lines.finish(60)
        assert rc == 0, err[-4000:]
    finally:
        lines.proc.kill()
        lines.proc.wait(timeout=30)
    assert "signal SIGTERM: draining" in out
    assert "shutdown complete (drained, final state spilled); exit 0" in out
    assert "accuracy" not in out
    live = ReverseKRanksEngine.restore(tmp_path, device="cpu"
                                       ).live_item_ids().size
    assert live > M and (live - M) % 4 == 0


def test_cli_metrics_endpoint_scrapes_then_sigint():
    lines = _lines(*SMALL, "--queries", "200000", "--max-batch", "8",
                   "--metrics-port", "0", "--stats-every", "64", "--device",
                   "cpu")
    try:
        url = lines.wait_for(r"^metrics: http://", TIMEOUT).split()[1]
        lines.wait_for(r"^  \[64/", TIMEOUT)
        with urllib.request.urlopen(url, timeout=30) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(url + ".json", timeout=30) as resp:
            snap = json.loads(resp.read())
        lines.proc.send_signal(signal.SIGINT)
        rc, out, err = lines.finish(60)
        assert rc == 0, err[-4000:]
    finally:
        lines.proc.kill()
        lines.proc.wait(timeout=30)
    assert "serve_request_latency_ms" in text
    assert "serve_request_latency_ms" in json.dumps(snap["metrics"])
    assert "shutdown complete" in out


def test_cli_mf_trains_the_embeddings():
    """The MF path end to end. At the driver's learning rate (the
    reference's MFConfig default) the loss moves by less than its epoch
    noise at this size, so the line is read, not its trend; the trainer
    learning is tests/test_torch_mf.py's case at lr 10."""
    out = _ok(_cli(*SMALL, "--mf", "--n-ratings", "20000", "--mf-epochs",
                   "3", "--queries", "16", "--max-batch", "8", "--device",
                   "cpu"))
    assert re.search(r"^MF losses: \d\.\d{4} → \d\.\d{4}$", out, re.M)
    m = re.search(r"^  MF: 3 epoch\(s\) of 2 steps in \S+s \(\S+ s/epoch\);"
                  r" losses \[(.*)\]$", out, re.M)
    assert m and len(m.group(1).split(",")) == 3
    _accuracy(out)
    args = serve_mod.build_parser().parse_args(
        SMALL + ["--mf", "--n-ratings", "20000", "--mf-epochs", "1",
                 "--device", "cpu"])
    users, items = serve_mod.build_embeddings(args)
    assert users.shape == (N, D + 2) and items.shape == (M, D + 2)


def test_cli_sharded_backend():
    out = _ok(_cli(*SMALL, "--queries", "16", "--max-batch", "8",
                   "--backend", "sharded", "--device", "cpu"))
    assert re.search(r"^serve: .*\(sharded backend", out, re.M)
    _accuracy(out)


def test_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    out = _cli(*SMALL, "--queries", "8")
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert "build:" not in out.stdout
