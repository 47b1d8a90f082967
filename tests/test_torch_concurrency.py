"""The port's concurrency auditor and its contracts
(racon_tpu_torch/analysis/concurrency) and the thread-discipline rule.

* Held against the JAX engines: the JAX fixture trees (races, lockcycle,
  protocol) copied to tmp_path with ``racon_tpu/`` renamed
  ``racon_tpu_torch/`` give the port's ``locks.audit`` and
  ``contracts.audit`` the JAX findings, rule, line and message, with the
  package prefix swapped; on a mini-tree whose ``lattice.py`` declares no
  tiers both extractors give the same ``record_degrade`` edges. The JAX
  engines run once, in a module fixture.
* Port-only behaviour, each firing exactly once on a mini-tree:
  thread-discipline, fault-drill and fault-docs (a JAX test or a row
  under docs/ does not count), the ``hello`` ``start`` field; a waiver
  silences a finding.
* The real tree is clean (one model and one contracts run, in a module
  fixture): its thread entries, ``Coordinator._fail_chunk``'s held lock,
  the 20 fault points, the two degrade edges, the declared protocol, and
  README's role table against ``THREAD_ROLE_PATTERNS``.
* The CLI: ``--concurrency`` and ``--contracts`` exit as the JAX CLI's,
  ``--paths`` scoping included; ``--json`` counts each rule; the audits
  import no torch (the one subprocess).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from racon_tpu.analysis.__main__ import main as jax_analysis_main
from racon_tpu.analysis.concurrency import contracts as jax_contracts
from racon_tpu.analysis.concurrency import locks as jax_locks
from racon_tpu_torch.analysis import lint
from racon_tpu_torch.analysis.__main__ import main as analysis_main
from racon_tpu_torch.analysis.concurrency import (UnsupportedScope,
                                                  contract_anchors,
                                                  contracts, locks,
                                                  run_contracts, roles)
from racon_tpu_torch.analysis.concurrency.model import Model
from racon_tpu_torch.analysis.rules import RULES_BY_ID
from racon_tpu_torch.resilience.faults import KNOWN_POINTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXROOT = os.path.join(ROOT, "tests", "analysis_fixtures", "concurrency")
FIXTURES = ("races", "lockcycle", "protocol")


def _write(root, rel, text):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return rel


def _port_copy(name, dest):
    """The JAX fixture tree `name` under dest, racon_tpu/ renamed
    racon_tpu_torch/ (the originals are only read)."""
    src = os.path.join(FIXROOT, name, "racon_tpu")
    shutil.copytree(src, os.path.join(str(dest), "racon_tpu_torch"))
    return str(dest)


def _swap(path):
    return "racon_tpu_torch/" + path[len("racon_tpu/"):] \
        if path.startswith("racon_tpu/") else path


def _rows(vs):
    return [(v.rule, v.path, v.line, v.message) for v in vs]


@pytest.fixture(scope="module")
def jax_fixture_findings():
    """The JAX engines over the original fixture trees, once a module."""
    out = {}
    for name in FIXTURES:
        tree = os.path.join(FIXROOT, name)
        out[name] = [(v.rule, _swap(v.path), v.line, v.message)
                     for v in jax_locks.audit(tree)
                     + jax_contracts.audit(tree)]
    return out


@pytest.fixture(scope="module")
def real_tree():
    """The model, the lock audit and the contracts over the real tree,
    once a module."""
    m = Model.build(ROOT)
    return m, locks.audit(ROOT, model=m), contracts.audit(ROOT)


# ------------------------------------------------ against the JAX engines

@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_findings_equal_jax(tmp_path, jax_fixture_findings, name):
    tree = _port_copy(name, tmp_path)
    got = _rows(locks.audit(tree) + contracts.audit(tree))
    assert got == jax_fixture_findings[name]
    assert len(got) == 1     # each fixture seeds exactly one finding


DEGRADE_SITES = {
    "racon_tpu/a.py": """\
        def run(rep):
            rep.record_degrade("fleet", "local")
            rep.record_degrade("pipelined", "sequential", None)
        """,
    "racon_tpu/b.py": """\
        def other(rep, x):
            rep.record_degrade("fleet", "local")   # a second site
            rep.record_degrade("a", x)             # not literal: no edge
            record_degrade("c", "d")               # not a method call
        """,
    "racon_tpu/resilience/lattice.py": '"""A lattice with no tiers."""\n',
}


def test_degrade_edges_equal_jax(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for rel, text in DEGRADE_SITES.items():
        _write(jax_root, rel, text)
        _write(port_root, _swap(rel), text)
    want = jax_contracts.lattice_edges(str(jax_root))
    got = contracts.degrade_edges(str(port_root))
    assert [(t, line) for t, (_, line) in got] == want
    assert got == [(("fleet", "local"), ("racon_tpu_torch/a.py", 2)),
                   (("pipelined", "sequential"),
                    ("racon_tpu_torch/a.py", 3))]


# ---------------------------------------------------- port-only behaviour

THREAD_SNIPPETS = {
    "no_daemon": """\
        import threading

        def go(f):
            threading.Thread(target=f, name="align-worker").start()
        """,
    "unregistered": """\
        import threading

        def go(f):
            threading.Thread(target=f, name="poa-warm", daemon=True).start()
        """,
    "sleep_under_lock": """\
        import threading
        import time

        _lock = threading.Lock()

        def go():
            with _lock:
                time.sleep(0.1)
        """,
}


@pytest.mark.parametrize("case", sorted(THREAD_SNIPPETS))
def test_thread_discipline_fires_once(tmp_path, case):
    rel = _write(tmp_path, "racon_tpu_torch/t.py", THREAD_SNIPPETS[case])
    vs = lint.run_lint(str(tmp_path), paths=[rel],
                       rules=[RULES_BY_ID["thread-discipline"]])
    assert [v.rule for v in vs] == ["thread-discipline"], vs
    # the port has no poa-warm thread; the JAX roles do
    assert not roles.role_is_registered("poa-warm")


def test_thread_discipline_suppression(tmp_path):
    text = THREAD_SNIPPETS["no_daemon"].replace(
        ".start()\n", ".start()  # lint: disable=thread-discipline\n")
    rel = _write(tmp_path, "racon_tpu_torch/t.py", text)
    assert lint.run_lint(str(tmp_path), paths=[rel],
                         rules=[RULES_BY_ID["thread-discipline"]]) == []


FAULTS_PY = """\
    KNOWN_POINTS = frozenset({
        "demo.point",
    })
    """
README_ROW = "| `demo.point` | a seam | ends the run |\n"


def _fault_tree(root, test_name, test_text, readme_port, extra=None):
    _write(root, "racon_tpu_torch/resilience/faults.py", FAULTS_PY)
    _write(root, f"tests/{test_name}", test_text)
    _write(root, "README.md",
           "## Usage\n\n| row | `demo.point` |\n\n"
           "## PyTorch / CUDA port\n\n" + readme_port
           + "\n## Configuration (environment)\n")
    for rel, text in (extra or {}).items():
        _write(root, rel, text)
    return [(v.rule, v.path) for v in contracts.audit(str(root))]


@pytest.mark.parametrize("drill", ["test_faults.py", "test_torch_faults.py"])
def test_fault_drill_counts_only_port_tests(tmp_path, drill):
    got = _fault_tree(tmp_path, drill, "# drills demo.point\n", README_ROW)
    want = ([] if drill.startswith("test_torch_") else
            [("fault-drill", "racon_tpu_torch/resilience/faults.py")])
    assert got == want


@pytest.mark.parametrize("where", ["docs", "readme_port"])
def test_fault_docs_counts_only_the_port_section(tmp_path, where):
    docs = {"docs/failures.md": README_ROW} if where == "docs" else {}
    got = _fault_tree(tmp_path, "test_torch_x.py", "# demo.point\n",
                      README_ROW if where == "readme_port" else "",
                      extra=docs)
    want = ([] if where == "readme_port" else
            [("fault-docs", "racon_tpu_torch/resilience/faults.py")])
    assert got == want


def test_degrade_edge_needs_a_port_drill_and_a_row(tmp_path):
    _write(tmp_path, "racon_tpu_torch/p.py", DEGRADE_SITES["racon_tpu/a.py"])
    _write(tmp_path, "tests/test_torch_x.py",
           "# pipelined -> sequential: the collapse degradation\n")
    _write(tmp_path, "tests/test_fleet.py", "# fleet -> local degrades\n")
    _write(tmp_path, "README.md",
           "## PyTorch / CUDA port\n\n| `pipelined` → `sequential` |\n")
    got = [(v.rule, v.path, v.line) for v in contracts.audit(str(tmp_path))]
    assert got == [("lattice-docs", "racon_tpu_torch/p.py", 2),
                   ("lattice-drill", "racon_tpu_torch/p.py", 2)]


def _protocol_tree(root, hello_opt, files):
    """The port's protocol declaration with `hello`'s opt set to
    `hello_opt`, and the listed distrib surfaces copied from the tree."""
    with open(os.path.join(ROOT, contracts._PROTOCOL_REL)) as f:
        text = f.read()
    decl = '"hello": {"req": ("worker",), "opt": ("start",),'
    assert decl in text
    _write(root, contracts._PROTOCOL_REL,
           text.replace(decl, '"hello": {"req": ("worker",), "opt": '
                        + repr(hello_opt) + ","))
    for rel in files:
        dst = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy(os.path.join(ROOT, rel), dst)
    return [(v.rule, v.path, v.message) for v in contracts.audit(str(root))
            if v.rule == "protocol-mismatch"]


@pytest.mark.parametrize("side", ["worker", "coordinator"])
def test_hello_start_field(tmp_path, side):
    rel = f"racon_tpu_torch/distrib/{side}.py"
    got = _protocol_tree(tmp_path / "bare", (), [rel])
    assert len(got) == 1 and got[0][1] == rel, got
    assert "start" in got[0][2] and "'hello'" in got[0][2]
    assert _protocol_tree(tmp_path / "decl", ("start",), [rel]) == []


def test_concurrency_waiver_silences_the_finding(tmp_path):
    tree = _port_copy("races", tmp_path)
    svc = os.path.join(tree, "racon_tpu_torch", "svc.py")
    with open(svc) as f:
        text = f.read()
    assert [v.rule for v in locks.audit(tree)] == ["unguarded-mutation"]
    with open(svc, "w") as f:
        f.write(text.replace("self.n = self.n + 1  # unguarded",
                             "self.n = self.n + 1  # concurrency: test"))
    assert locks.audit(tree) == []


# -------------------------------------------------------------- real tree

def test_real_tree_clean(real_tree):
    _, lock_vs, contract_vs = real_tree
    assert [v.render() for v in lock_vs + contract_vs] == []
    vs = lint.run_lint(ROOT, rules=[RULES_BY_ID["thread-discipline"]])
    assert [v.render() for v in vs] == []


PORT_ROLES = {
    "align-worker", "distrib-accept", "distrib-conn", "distrib-heartbeat",
    "fleet-accept", "fleet-conn", "fleet-monitor", "loadtest-c*",
    "loadtest-stats", "mem-watchdog", "racon-torch-watchdog-call",
    "sanitize-stats-probe", "serve-*-lane", "serve-accept", "serve-conn",
    "serve-metrics-http"}


def test_real_tree_thread_entries(real_tree):
    m = real_tree[0]
    port = [te for te in m.thread_entries
            if te.relpath.startswith("racon_tpu_torch/")]
    assert len(port) == 16
    assert {te.role for te in port} == PORT_ROLES
    smoke = {te.role for te in m.thread_entries
             if te.relpath == "chip_smoke.py"}
    assert smoke == {"smoke-serve-fleet", "smoke-client-*"}
    # every entry's role is registered, and every registered pattern but
    # the smoke's is a role some entry of the port takes
    assert all(roles.role_is_registered(te.role) for te in m.thread_entries)
    assert {roles.role_of(r) for r in PORT_ROLES} | {"smoke-*"} == \
        set(roles.THREAD_ROLE_PATTERNS)
    assert m.acquires, "no lock acquisition modelled"
    assert locks._lock_order_cycles(m) == []


def test_fail_chunk_runs_under_the_coordinators_lock(real_tree):
    """Every caller of Coordinator._fail_chunk holds Coordinator._cv, and
    the model credits it (no waiver needed on the method)."""
    m = real_tree[0]
    q = "racon_tpu_torch/distrib/coordinator.py::Coordinator._fail_chunk"
    sites = [cs for cs in m.calls if cs.callee == q]
    assert len(sites) == 3
    assert all("Coordinator._cv" in cs.held for cs in sites)
    assert "Coordinator._cv" in m.functions[q].entry_locks
    assert not m.functions[q].waived


def test_real_tree_contract_sets():
    assert [p for p, _ in contracts.fault_points(ROOT)] == \
        sorted(KNOWN_POINTS)
    assert len(KNOWN_POINTS) == 20
    edges = contracts.degrade_edges(ROOT)
    assert [(t, rel) for t, (rel, _) in edges] == [
        (("fleet", "local"), "racon_tpu_torch/distrib/coordinator.py"),
        (("pipelined", "sequential"), "racon_tpu_torch/polisher.py")]
    spec, common, payloads = contracts._declared_protocol(ROOT)
    assert set(spec) == {"serve", "distrib"}
    assert spec["distrib"]["hello"]["opt"] == ("start",)
    assert "distrib.fetch.chunk" in payloads and "ok" in common


def test_readme_role_table_equals_the_registry():
    with open(os.path.join(ROOT, "README.md")) as f:
        lines = f.read().splitlines()
    start = lines.index("| role | thread |")
    table = {}
    for line in lines[start + 2:]:
        if not line.startswith("|"):
            break
        role, desc = [c.strip() for c in line.strip("|").split("|")]
        table[role.strip("`")] = desc
    assert table == roles.THREAD_ROLE_PATTERNS


# -------------------------------------------------------------------- CLI

CLI_CASES = [
    ("races", ["--concurrency"]),
    ("races", ["--concurrency", "--paths", "{pkg}/svc.py"]),
    ("races", ["--contracts"]),
    ("lockcycle", ["--concurrency", "--contracts"]),
    ("protocol", ["--contracts"]),
    ("protocol", ["--contracts", "--paths", "{pkg}/serve/client.py"]),
    ("protocol", ["--contracts", "--paths", "{pkg}/serve/server.py"]),
    ("protocol", ["--contracts", "--paths", "{pkg}/nothing.py"]),
    ("protocol", ["--concurrency"]),
]


@pytest.mark.parametrize("name,argv", CLI_CASES)
def test_cli_exit_codes_equal_jax(tmp_path, capsys, name, argv):
    tree = _port_copy(name, tmp_path)
    jax_argv = [a.format(pkg="racon_tpu") for a in argv]
    port_argv = [a.format(pkg="racon_tpu_torch") for a in argv]
    want = jax_analysis_main(jax_argv + ["--repo-root",
                                         os.path.join(FIXROOT, name)])
    assert analysis_main(port_argv + ["--repo-root", tree]) == want
    capsys.readouterr()


def test_contracts_scope_without_an_anchor():
    with pytest.raises(UnsupportedScope):
        run_contracts(ROOT, paths=["racon_tpu_torch/polisher.py"])
    assert "racon_tpu_torch/serve/protocol.py" in contract_anchors()
    assert run_contracts(ROOT, paths=sorted(contract_anchors())) == []


def test_cli_json_counts_each_rule(tmp_path, capsys):
    tree = _port_copy("races", tmp_path)
    assert analysis_main(["--concurrency", "--contracts", "--json",
                          "--repo-root", tree]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["rules"]["unguarded-mutation"] == 1
    assert all(doc["rules"][r] == 0 for r in (
        "lock-order-cycle", "lattice-drill", "lattice-docs", "fault-drill",
        "fault-docs", "protocol-mismatch"))
    assert doc["concurrency"]["roles"] == ["serve-conn"]
    assert "contracts" in doc and "thread-discipline" not in doc["rules"]


def test_audits_import_no_torch():
    """The CLI's audits on the real tree in a fresh interpreter: exit 0,
    every new rule counted at 0, and neither torch nor JAX imported."""
    code = ("import json, sys, io, contextlib\n"
            "from racon_tpu_torch.analysis.__main__ import main\n"
            "buf = io.StringIO()\n"
            "with contextlib.redirect_stdout(buf):\n"
            "    rc = main(['--concurrency', '--contracts', '--json'])\n"
            "doc = json.loads(buf.getvalue())\n"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith(('torch.', 'jax', 'racon_tpu.'))]\n"
            "print(json.dumps({'rc': rc, 'rules': doc['rules'], "
            "'bad': bad}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["rc"] == 0 and out["bad"] == []
    assert set(out["rules"]) == {
        "unguarded-mutation", "lock-order-cycle", "lattice-drill",
        "lattice-docs", "fault-drill", "fault-docs", "protocol-mismatch"}
    assert not any(out["rules"].values())
