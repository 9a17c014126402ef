"""The paper's examples on the port (`repro_torch.examples`), on the CPU.

Each example is a `main(*, device=None, **sizes)` whose sizes default to
the reference example's module constants (read from its file: the
reference examples run at import). Here each runs at a small size on the
CPU and must print the reference example's lines and grade its answers
with the §5 metrics (accuracy in [0, 1], overall ratio finite and ≥ 1).
The CLI-style runs under the import blocker are in
tests/test_torch_imports.py. Step 4 of `serve_retrieval` (backbone-
encoded embeddings) is held against the reference's: its embeddings
within the tolerance each case states, and, fed the reference's
parameters, token sequences, sample positions and weights, its answer
equal to the reference's.

Hygiene: two intra-op threads; the MicroBatcher of `serve_retrieval` is
closed by its `with` block.
"""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import ablation, quickstart, serve_retrieval

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reference_constants(name: str) -> dict:
    """Module-level constants of a reference example, and the keywords of
    its calls that are literals."""
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       (ast.Tuple, ast.Name)):
            names = (node.targets[0].elts
                     if isinstance(node.targets[0], ast.Tuple)
                     else [node.targets[0]])
            values = (node.value.elts if isinstance(node.value, ast.Tuple)
                      else [node.value])
            for n, v in zip(names, values):
                if isinstance(n, ast.Name) and isinstance(v, ast.Constant):
                    out[n.id] = v.value
        if isinstance(node, ast.keyword) and isinstance(node.value,
                                                        ast.Constant):
            out.setdefault(node.arg, node.value.value)
    return out


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("module, name, mapping", [
    (quickstart, "quickstart", dict(n_users="N_USERS", n_items="N_ITEMS",
                                    dim="DIM", k="K", c="C")),
    (ablation, "ablation", dict(n="N", m="M", d="D", k="K", c="C",
                                n_eval="N_EVAL")),
    (serve_retrieval, "serve_retrieval", dict(
        n_users="N_USERS", n_items="N_ITEMS", n_ratings="n_obs", k="K",
        c="C")),
])
def test_sizes_default_to_the_reference_example(module, name, mapping):
    ref = _reference_constants(name)
    ours = _defaults(module.main)
    assert ours.pop("device") is None
    assert ours == {k: ref[v] for k, v in mapping.items()}


def _graded(acc, ratio):
    assert 0.0 <= acc <= 1.0
    assert np.isfinite(ratio) and ratio >= 1.0


def test_quickstart_small(capsys):
    got = quickstart.main(device="cpu", n_users=1000, n_items=400, dim=32)
    _graded(got["accuracy"], got["overall_ratio"])
    out = capsys.readouterr().out.splitlines()
    for head in ("index built:", "top-10 users for item 42:",
                 "estimated ranks:", "Lemma-1 closed the search in step 2:",
                 "accuracy="):
        assert any(ln.startswith(head) for ln in out), head


def test_ablation_small(capsys):
    rows = ablation.main(device="cpu", n=1000, m=400, d=32, n_eval=3)
    assert [r[0] for r in rows] == [f"omega={o},s={s},mode={mode}"
                                    for o, s, mode in ablation.CONFIGS]
    for _, acc, ratio in rows:
        _graded(acc, ratio)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["config", "acc", "ratio", "build_s"]
    assert len(out) == 1 + len(ablation.CONFIGS)


def test_serve_retrieval_small(capsys):
    got = serve_retrieval.main(device="cpu", n_users=600, n_items=250,
                               n_ratings=30_000)
    assert len(got["losses"]) == 8 and got["losses"][-1] < got["losses"][0]
    _graded(got["accuracy"], got["overall_ratio"])
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("MF: rmse-ish loss") and ln.endswith(
        "embeddings d=66") for ln in out)
    assert any(ln.startswith("served 16 queries in") and
               "(cached:dense backend)" in ln for ln in out)
    assert any(ln.startswith("accuracy ") for ln in out)
    assert any(ln.startswith("backbone-embedded reverse 5-ranks for item 7 "
                             "→ users [") for ln in out)


def test_examples_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for main in (quickstart.main, ablation.main, serve_retrieval.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()


# ------------------------------------------------- step 4 of serve_retrieval
def _reference_step4(dtype):
    """The reference example's step 4 (its file runs at import, so its
    lines are repeated here on the reference's functions): reduced
    gemma-2b, parameters from PRNGKey(3), token sequences, embeddings."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.models import transformer as RT
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")), dtype=dtype)
    params = RT.init_params(jax.random.PRNGKey(3), cfg)
    tok_u = jax.random.randint(jax.random.PRNGKey(4), (96, 16), 0,
                               cfg.vocab)
    tok_i = jax.random.randint(jax.random.PRNGKey(5), (48, 16), 0,
                               cfg.vocab)

    def encode(tokens):
        x = RT._embed(params, tokens, cfg)
        x = RT._apply_segments(params["segments"], cfg.segments(), x, cfg,
                               jnp.arange(tokens.shape[1]))
        return x.mean(axis=1).astype(jnp.float32)

    return cfg, params, tok_u, tok_i, encode(tok_u), encode(tok_i)


def _port_step4_inputs(dtype, params, tok_u, tok_i):
    import dataclasses
    import jax
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")), dtype=dtype)
    pp = convert.model_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    return (cfg, pp, torch.from_numpy(np.array(tok_u)).long(),
            torch.from_numpy(np.array(tok_i)).long())


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_backbone_embeddings_match_the_reference(dtype, tol):
    """float32 within 1e-5; the config's bf16 within 2e-2 (the mean of
    16 bf16 activations, each within a few bf16 ulps of the
    reference's)."""
    _, params, tok_u, tok_i, u_ref, i_ref = _reference_step4(dtype)
    cfg, pp, tu, ti = _port_step4_inputs(dtype, params, tok_u, tok_i)
    for toks, want in ((tu, u_ref), (ti, i_ref)):
        got = serve_retrieval.backbone_embeddings(pp, cfg, toks, batch=40)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_backbone_step_answers_with_the_references_indices(capsys):
    import dataclasses
    import jax
    from repro.core import ReverseKRanksEngine as RefEngine
    from repro.core.rank_table import sampling_artifacts
    from repro.core.types import RankTableConfig as RefConfig
    _, params, tok_u, tok_i, u_ref, i_ref = _reference_step4("float32")
    key = jax.random.PRNGKey(6)
    ref_table = RefConfig(tau=64, omega=4, s=16)
    eng = RefEngine.build(u_ref, i_ref, ref_table, key)
    want = eng.query(i_ref[7], k=5, c=2.0)
    art = sampling_artifacts(i_ref, ref_table, key)
    cfg, pp, tu, ti = _port_step4_inputs("float32", params, tok_u, tok_i)
    assert dataclasses.asdict(serve_retrieval.BACKBONE_TABLE) == \
        dataclasses.asdict(ref_table)
    out = serve_retrieval.backbone_step(
        torch.device("cpu"), cfg=cfg, params=pp, tok_u=tu, tok_i=ti,
        positions=torch.from_numpy(np.array(art.positions)).long(),
        weights=torch.from_numpy(np.array(art.weights)))
    assert out["result"].indices.tolist() == np.asarray(
        want.indices).tolist()
    assert out["engine"].backend_name == "fused"
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"backbone-embedded reverse 5-ranks for item 7 → users "
                    f"{np.asarray(want.indices).tolist()} (engine composes "
                    "with any arch)")


def test_serve_retrieval_runs_step_4_reduced_on_the_cpu(capsys):
    cfg = serve_retrieval.backbone_config(torch.device("cpu"))
    assert cfg.name == "gemma-2b" and cfg.d_model == 64
    out = serve_retrieval.backbone_step(torch.device("cpu"), n_users=64,
                                        n_items=32)
    assert out["users"].shape == (64, 64) and out["items"].shape == (32, 64)
    assert len(out["result"].indices) == 5
    assert "backbone-embedded reverse 5-ranks" in capsys.readouterr().out
