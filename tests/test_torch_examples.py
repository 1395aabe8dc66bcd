"""The port's entry points under ``examples/*_torch.py``, called in process
with ``--device cpu``: the DMRG entry point on both of the paper's systems
against exact diagonalization, its ``--stats-json`` payload against the
reference script's keys, the quickstart, and the two LM entry points at smoke
size; and the four files import nothing of JAX or of the JAX package.
"""
import ast
import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
PORT_EXAMPLES = ("dmrg_groundstate_torch", "quickstart_torch", "serve_lm_torch", "train_lm_torch")


def load(name):
    spec = importlib.util.spec_from_file_location(f"examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(name, argv):
    """``main(argv)`` of an example, with what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = load(name).main(argv)
    return out, buf.getvalue()


def ed_error(text: str) -> float:
    return float(re.search(r"ED reference: +\S+ \(\|err\|=(\S+)\)", text).group(1))


@pytest.mark.parametrize("argv", [
    ["--system", "electrons", "--lx", "2", "--ly", "2"],
    ["--system", "spins", "--lx", "3", "--ly", "2"],
], ids=["electrons_2x2", "spins_3x2"])
def test_dmrg_example_matches_ed(argv):
    """The entry point's default schedule and its ED line: |err| <= 1e-8."""
    res, text = run_main("dmrg_groundstate_torch", argv + ["--check-ed", "--device", "cpu"])
    assert ed_error(text) <= 1e-8
    assert f"ground-state energy estimate: {res.energy:.10f}" in text


def _reference_payload_keys():
    """The keys of the reference script's ``--stats-json`` payload, read
    from its source (running it would trace and compile JAX)."""
    tree = ast.parse((EXAMPLES / "dmrg_groundstate.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "payload" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if getattr(target.value, "id", None) == "payload":
                keys.add(target.slice.value)
    return keys


def test_stats_json_has_the_reference_keys(tmp_path):
    """``--stats-json`` writes the reference's payload: its top-level keys
    (``spmd`` only under ``--spmd``), and under ``caches`` the keys of the
    reference's ``repro.dist.cache_stats`` plus the run's engine stats."""
    from repro.dist import cache_stats as jax_cache_stats

    _, text = run_main("dmrg_groundstate_torch", ["--system", "electrons", "--lx", "2", "--ly", "1", "--max-bond", "8",
                                                  "--sweeps-per-bond", "1", "--device", "cpu", "--stats-json", "-"])
    payload = json.loads(text[text.index("\n{") + 1:])
    assert set(payload) == _reference_payload_keys() - {"spmd"}
    assert set(payload["caches"]) == set(jax_cache_stats()) | {"engines"}
    assert payload["caches"]["plan_cache"]["builds"] > 0
    assert payload["n_sites"] == 2 and payload["schedule"] == [8]
    path = tmp_path / "stats.json"
    run_main("dmrg_groundstate_torch", ["--system", "electrons", "--lx", "2", "--ly", "1", "--max-bond", "8",
                                        "--sweeps-per-bond", "1", "--device", "cpu", "--stats-json", str(path)])
    assert json.loads(path.read_text())["energy"] == payload["energy"]


@pytest.mark.parametrize("argv", [
    ["--shard", "--spmd"],
    ["--algo", "list_unplanned", "--jit-matvec"],
    ["--algo", "list_unplanned", "--svd-method", "svd"],
], ids=["shard_and_spmd", "unplanned_jit", "unplanned_svd"])
def test_dmrg_example_refuses_what_the_reference_refuses(argv, capsys):
    with pytest.raises(SystemExit):
        load("dmrg_groundstate_torch").main(argv + ["--device", "cpu"])
    assert "error:" in capsys.readouterr().err


def test_dmrg_example_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main("dmrg_groundstate_torch", ["--lx", "2", "--ly", "1", "--max-bond", "8"])


def test_quickstart():
    (e_dmrg, e_exact), text = run_main("quickstart_torch", ["--device", "cpu"])
    assert abs(e_dmrg - e_exact) < 1e-8 and "OK" in text


def test_serve_lm_example():
    tokens, _ = run_main("serve_lm_torch", ["--arch", "llama3_8b", "--gen-len", "4", "--device", "cpu"])
    assert tuple(tokens.shape) == (4, 4)


def test_train_lm_example(tmp_path):
    """Two smoke steps, checkpointed; a rerun to four resumes at two."""
    ck = str(tmp_path / "ckpt")
    losses, _ = run_main("train_lm_torch", ["--steps", "2", "--checkpoint-dir", ck, "--device", "cpu"])
    assert len(losses) == 2 and all(map(torch.isfinite, torch.tensor(losses)))
    resumed, text = run_main("train_lm_torch", ["--steps", "4", "--checkpoint-dir", ck, "--device", "cpu"])
    assert "resumed from step 2" in text and len(resumed) == 2


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_example_imports_nothing_of_jax(name):
    """No import of ``jax`` or of the JAX package ``repro``, at any depth of
    the file (imports inside functions included)."""
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    modules = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules.append(node.module or "")
    assert modules and not [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert any(m.startswith("repro_torch") for m in modules)
