"""The port's determinism taint audit (racon_tpu_torch/analysis/
determinism) against the JAX package's (racon_tpu/analysis/determinism),
on the CPU.

* Held against the JAX engine: the JAX leak, gap and overkey fixtures
  translated to the port's source form (a ``SOURCES`` entry of
  fingerprint.py in place of a ``config.py`` knob; a parameter in place
  of a ``config.get_*`` read) each fire their rule once, at the JAX
  finding's line: the install seam for the leak, the site and the
  component for the fingerprint rules. The JAX engine runs on the
  originals, once a fixture.
* The engine's rules: a ``# determinism:`` waiver silences the leak; an
  environment source seeds taint at its ``os.environ.get`` read; a
  function passed on as an argument (``self._timed(stats, name, fn,
  *args, **kwargs)``) gets the forwarded arguments; a queue's bound does
  not taint its items, what is put in does.
* The real tree (one audit, in a module fixture): clean; every
  ``SOURCES`` entry read and classified cost-only; its only flows into
  the install seams the two waived journal replays; the manifest lists
  both fingerprint sites; each of the four seeded mutants is caught and
  an unknown one refused.
* The CLI: ``--determinism``, ``--emit-manifest`` (a round trip),
  ``--det-mutate``, ``--list-det-mutations`` and ``--paths`` scoping;
  and, in the one subprocess, the engines and a full-tree run import no
  torch and nothing of JAX.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from racon_tpu.analysis.determinism import build_audit as jax_build_audit
from racon_tpu_torch import fingerprint
from racon_tpu_torch.analysis.__main__ import main as analysis_main
from racon_tpu_torch.analysis.determinism import (MUTANTS, build_audit,
                                                  run_determinism,
                                                  run_mutant)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXROOT = os.path.join(ROOT, "tests", "analysis_fixtures", "determinism")
PKG = "racon_tpu_torch"


def _write(root, rel, text):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))


def _read(*parts):
    with open(os.path.join(FIXROOT, *parts)) as f:
        return f.read()


def _swap(path):
    return path.replace("racon_tpu/", f"{PKG}/")


# -- the JAX fixtures in the port's source form ------------------------------

def _leak_tree(root, waiver=""):
    """The leak fixture: the knob RACON_TPU_DEPTH, declared cost-only and
    read by config.get_int, becomes the source `depth`, a parameter of
    polish() declared cost-only; the code keeps its lines, so the seam
    is at the JAX fixture's line."""
    code = _read("leak", "racon_tpu", "ops", "code.py").replace(
        "from .. import config\n", "\n").replace(
        "def polish(pipeline, windows):",
        "def polish(pipeline, windows, depth):").replace(
        '    depth = config.get_int("RACON_TPU_DEPTH")\n',
        f"    {waiver}\n" if waiver else "    pass\n")
    _write(root, f"{PKG}/ops/code.py", code)
    _write(root, f"{PKG}/__init__.py", "")
    _write(root, f"{PKG}/ops/__init__.py", "")
    _write(root, f"{PKG}/fingerprint.py", """\
        SOURCES = (
            ("depth", "racon_tpu_torch/ops/code.py", "polish", "depth",
             False),
        )
        """)
    return str(root)


def _gap_tree(root):
    """The gap fixture: the output-affecting knob RACON_TPU_SEED becomes
    the source `seed`, declared affects_output; SITES and OUTPUT_SOURCES
    keep their text and lines, SOURCES follows them."""
    text = _read("gap", "racon_tpu", "fingerprint.py") + textwrap.dedent(
        """\

        SOURCES = (
            ("seed", "racon_tpu_torch/ops/code.py", "polish", "seed", True),
        )
        """)
    _write(root, f"{PKG}/fingerprint.py", text)
    return str(root)


def _overkey_tree(root):
    """The overkey fixture: the cost-only knob RACON_TPU_TIER becomes the
    source `tier`, and the component keys on ``source:tier``."""
    text = _read("overkey", "racon_tpu", "fingerprint.py").replace(
        '"knob:RACON_TPU_TIER"', '"source:tier"') + textwrap.dedent(
        """\

        SOURCES = (
            ("tier", "racon_tpu_torch/ops/code.py", "polish", "tier",
             False),
        )
        """)
    _write(root, f"{PKG}/fingerprint.py", text)
    return str(root)


TREES = {"leak": _leak_tree, "gap": _gap_tree, "overkey": _overkey_tree}


@pytest.fixture(scope="module")
def jax_findings():
    """The JAX engine over the original fixture trees, once a fixture."""
    out = {}
    for name in TREES:
        res = jax_build_audit(os.path.join(FIXROOT, name))
        out[name] = [(v.rule, _swap(v.path), v.line)
                     for v in res.violations + res.warnings]
    return out


@pytest.mark.parametrize("name", sorted(TREES))
def test_fixture_fires_its_jax_rule_once_at_the_jax_line(
        tmp_path, jax_findings, name):
    res = build_audit(TREES[name](tmp_path))
    got = [(v.rule, v.path, v.line) for v in res.violations + res.warnings]
    assert got == jax_findings[name] and len(got) == 1
    if name == "overkey":
        assert not res.violations and "tier" in res.warnings[0].message
    else:
        assert not res.warnings
    if name == "leak":
        assert "set_consensus" in res.violations[0].message
    if name == "gap":
        assert "source:seed" in res.violations[0].message


def test_waiver_silences_the_leak(tmp_path):
    root = _leak_tree(tmp_path, waiver="# determinism: fixture demonstrates "
                                       "a waived flow")
    code = os.path.join(root, PKG, "ops", "code.py")
    with open(code) as f:
        text = f.read()
    with open(code, "w") as f:
        f.write(text.replace(
            "        pipeline.set_consensus(",
            "        # determinism: fixture demonstrates a waived flow\n"
            "        pipeline.set_consensus("))
    res = build_audit(root)
    assert not res.violations, [v.render() for v in res.violations]
    flows = res.manifest["sources"]["depth"]["sink_flows"]
    assert len(flows) == 1
    assert flows[0]["waived"] == "fixture demonstrates a waived flow"
    assert res.manifest["sources"]["depth"]["verdict"] == "cost-only"


def test_run_determinism_entry_point_shape(tmp_path):
    vs = run_determinism(_leak_tree(tmp_path / "leak"))
    assert [v.rule for v in vs] == ["determinism-leak"]
    assert run_determinism(_overkey_tree(tmp_path / "overkey")) == []


# -- the port's modelling rules ----------------------------------------------

ENV_TREE = {
    f"{PKG}/fingerprint.py": """\
        SOURCES = (
            ("RACON_TORCH_FAULT", "racon_tpu_torch/faults.py", "spec",
             "env:RACON_TORCH_FAULT", False),
        )
        """,
    f"{PKG}/faults.py": """\
        import os

        ENV = "RACON_TORCH_FAULT"


        def spec():
            return os.environ.get(ENV, "")
        """,
    f"{PKG}/ops.py": """\
        import queue

        from .faults import spec


        def run(fn, *args, **kwargs):
            return fn(*args, **kwargs)


        def install(pipeline, windows, tag):
            for i, w in enumerate(windows):
                pipeline.set_consensus(i, w + tag, True)


        def polish(pipeline, windows, depth):
            q = queue.Queue(maxsize=depth)
            q.put(windows)
            run(install, pipeline, q.get(), tag=spec())
        """,
}


def test_env_source_reaches_a_seam_through_a_forwarded_call(tmp_path):
    for rel, text in ENV_TREE.items():
        _write(tmp_path, rel, text)
    res = build_audit(str(tmp_path))
    assert [(v.rule, v.path, v.line) for v in res.violations] == [
        ("determinism-leak", f"{PKG}/ops.py", 12)]
    src = res.manifest["sources"]["RACON_TORCH_FAULT"]
    assert src["reads"] == [{"path": f"{PKG}/faults.py", "line": 7,
                             "func": f"{PKG}/faults.py::spec"}]
    assert src["verdict"] == "output-affecting"


def test_queue_bound_does_not_taint_its_items_but_a_put_does(tmp_path):
    tree = dict(ENV_TREE)
    tree[f"{PKG}/fingerprint.py"] = """\
        SOURCES = (
            ("depth", "racon_tpu_torch/ops.py", "polish", "depth", False),
        )
        """
    for rel, text in tree.items():
        _write(tmp_path / "bound", rel, text)
    assert build_audit(str(tmp_path / "bound")).violations == []
    tree[f"{PKG}/ops.py"] = tree[f"{PKG}/ops.py"].replace(
        "q.put(windows)", "q.put([w * depth for w in windows])")
    for rel, text in tree.items():
        _write(tmp_path / "put", rel, text)
    res = build_audit(str(tmp_path / "put"))
    assert [(v.rule, v.line) for v in res.violations] == [
        ("determinism-leak", 12)]


# -- the real tree -----------------------------------------------------------

@pytest.fixture(scope="module")
def real_audit():
    """One full-tree audit shared by every real-tree test."""
    return build_audit(ROOT)


def test_real_tree_is_clean(real_audit):
    assert not real_audit.violations, \
        [v.render() for v in real_audit.violations]
    assert not real_audit.warnings, \
        [v.render() for v in real_audit.warnings]


def test_every_source_is_read_and_classified(real_audit):
    man = real_audit.manifest
    names = [s[0] for s in fingerprint.SOURCES]
    assert sorted(man["sources"]) == sorted(names)
    for name, entry in man["sources"].items():
        assert entry["verdict"] == "cost-only", (name, entry)
        assert entry["declared_affects_output"] is False
        assert len(entry["reads"]) >= 1, name
    reads = man["sources"]["RACON_TORCH_FAULT"]["reads"]
    assert [r["func"] for r in reads] == [
        f"{PKG}/resilience/faults.py::active_spec"]
    assert man["sources"]["device"]["reads"][0]["func"] == \
        f"{PKG}/polisher.py::TorchPolisher.__init__"


def test_every_card_argument_of_the_polisher_is_a_source():
    import inspect

    from racon_tpu_torch.polisher import TorchPolisher

    params = [p for p in inspect.signature(TorchPolisher.__init__)
              .parameters.values()
              if p.kind == p.KEYWORD_ONLY and p.name not in (
                  "journal_path", "resume_journal")]
    declared = {s[3] for s in fingerprint.SOURCES
                if s[2] == "TorchPolisher.__init__"}
    assert {p.name for p in params} == declared


def test_real_tree_journal_flows_are_waived(real_audit):
    flows = [(name, f) for name, e in
             real_audit.manifest["sources"].items()
             for f in e["sink_flows"]]
    assert {f["seam"] for _, f in flows} == {"set_consensus",
                                             "set_job_cigar"}
    assert {f["path"] for _, f in flows} == {
        f"{PKG}/resilience/journal.py"}
    assert all(f.get("waived") for _, f in flows), flows


def test_manifest_lists_both_fingerprint_sites(real_audit):
    man = real_audit.manifest
    assert man["version"] == 1
    assert set(man["sites"]) == set(fingerprint.SITES) == {
        "journal", "serve_job_dir"}
    domain = set(man["required_domain"])
    assert domain == set(fingerprint.OUTPUT_SOURCES)
    for name, site in man["sites"].items():
        assert site["complete"] and site["components"], name
        assert domain <= set(site["expanded_coverage"]), name


def test_fingerprint_hashing_is_unchanged(tmp_path):
    """The registry is literals only: the fingerprint stays the JAX
    package's on the same inputs."""
    from racon_tpu import fingerprint as jax_fingerprint

    p = tmp_path / "in.fa"
    p.write_text(">a\nACGT\n")
    params = {"window_length": 500, "num_threads": 4, "match": 3}
    assert fingerprint.journal_fingerprint([str(p)], params, "torch") == \
        jax_fingerprint.journal_fingerprint([str(p)], params, "torch")


@pytest.mark.parametrize("name", [m[0] for m in MUTANTS])
def test_seeded_mutant_is_caught(name, capsys):
    """Each mutant through the CLI: exit 1, its expected rule reported."""
    expected = {m[0]: m[2] for m in MUTANTS}[name]
    assert analysis_main(["--det-mutate", name]) == 1
    out = capsys.readouterr().out
    assert f"[{expected}]" in out
    assert f"determinism mutant {name}: CAUGHT" in out


def test_unknown_mutant_is_refused(capsys):
    with pytest.raises(ValueError):
        run_mutant(ROOT, "no-such-mutant")
    assert analysis_main(["--det-mutate", "no-such-mutant"]) == 2
    assert "unknown determinism mutant" in capsys.readouterr().err


# -- the CLI -----------------------------------------------------------------

def test_cli_determinism_clean_and_list(tmp_path, capsys):
    # the overkey tree: a warning only, so exit 0
    root = _overkey_tree(tmp_path)
    assert analysis_main(["--repo-root", root, "--determinism"]) == 0
    out = capsys.readouterr().out
    assert "[warn]" in out and "OK: no new violations" in out
    assert analysis_main(["--list-det-mutations"]) == 0
    out = capsys.readouterr().out
    for m in MUTANTS:
        assert m[0] in out and m[2] in out


def test_cli_manifest_round_trip(tmp_path, capsys):
    root = _leak_tree(tmp_path / "tree")
    dest = str(tmp_path / "determinism.json")
    assert analysis_main(["--repo-root", root, "--emit-manifest", dest,
                          "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [v["rule"] for v in doc["new"]] == ["determinism-leak"]
    assert doc["determinism"]["verdicts"] == {"output-affecting": 1}
    with open(dest) as f:
        assert json.load(f) == build_audit(root).manifest
    assert analysis_main(["--repo-root", root, "--emit-manifest", "-"]) \
        == 1
    out = capsys.readouterr().out
    assert json.loads(out[:out.rindex("}") + 1])["version"] == 1


def test_cli_paths_scoped_run(tmp_path, capsys):
    root = _leak_tree(tmp_path)
    argv = ["--repo-root", root, "--determinism"]
    assert analysis_main(argv + ["--paths", f"{PKG}/ops/code.py"]) == 1
    assert "determinism-leak" in capsys.readouterr().out
    # out of scope, the flow is invisible; the registries still judged
    assert analysis_main(argv + ["--paths", f"{PKG}/__init__.py"]) == 0
    capsys.readouterr()
    # a --paths run without an audit flag stays lint-only
    analysis_main(["--repo-root", root, "--paths", f"{PKG}/ops/code.py"])
    assert "determinism-leak" not in capsys.readouterr().out


def test_engines_import_no_torch():
    """The model checker and a full-tree run (the lint, both concurrency
    audits, the determinism audit, the model's conformance) in a fresh
    interpreter: exit 0, and neither torch nor JAX nor the JAX package
    imported."""
    code = ("import sys, io, contextlib\n"
            "from racon_tpu_torch.analysis.__main__ import main\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    rcs = [main(['--model-check', '--mc-chunks', 'A,A',\n"
            "                 '--mc-submits', '2']), main([])]\n"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith(('torch.', 'jax', 'racon_tpu.'))]\n"
            "print(rcs, bad)\n"
            "sys.exit(1 if any(rcs) or bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
