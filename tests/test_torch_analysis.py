"""The port's static analysis (racon_tpu_torch/analysis): the lint, the
CUDA-source audit and the CLI.

* Each of the five lint rules fires exactly on a snippet written under
  tmp_path (a tree laid out as the port's), and the real tree is clean.
* Each source-audit rule fires on a seeded copy of ``csrc/`` in tmp_path,
  and the real ``csrc/`` is clean (comments that say "double buffer" and
  ``static_assert`` are not flagged).
* The CLI: ``--sanitize-report`` exits as the JAX CLI
  (``racon_tpu.analysis.__main__.main``) does on the same report JSON;
  ``--list-rules``; the baseline round trip; exit 0 on the tree, 1 on a
  seeded snippet.
* Importing ``racon_tpu_torch.analysis`` and running the lint, the source
  audit and ``--sanitize-report`` imports no torch (the one subprocess).

One lint pass over the real tree, in a module fixture.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from racon_tpu.analysis.__main__ import main as jax_analysis_main
from racon_tpu_torch.analysis import build_audit, lint
from racon_tpu_torch.analysis.__main__ import main as analysis_main
from racon_tpu_torch.analysis.rules import RULES_BY_ID

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def real_tree():
    """The lint and the source audit over the real tree, once."""
    return lint.run_lint(ROOT), build_audit.run_source_audit(ROOT)


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return rel


def _lint(root, rel, rule):
    return [(v.rule, v.line) for v in
            lint.run_lint(str(root), paths=[rel], rules=[RULES_BY_ID[rule]])]


# ------------------------------------------------------------------- lint

ENV_SNIPPET = """\
import os
from racon_tpu_torch.resilience import faults

ENV = "PYTHONPATH"
OTHER = "RACON_TPU_BAND"

a = os.environ.get("RACON_TORCH_FAULT", "")
b = os.environ.get("RACON_TPU_BAND")
c = os.environ["HOME"]
d = "FOO" in os.environ
e = os.getenv(faults.ENV)
f = os.environ.get(ENV)
g = os.environ.get(OTHER)
env = dict(os.environ)
os.environ["RACON_TPU_X"] = "1"
h = env.get("RACON_TPU_Y")
i = os.getenv("SHELL")  # lint: disable=env-registry
"""


def test_env_registry_fires_exactly(tmp_path):
    rel = _write(tmp_path, "racon_tpu_torch/tools/envy.py", ENV_SNIPPET)
    assert _lint(tmp_path, rel, "env-registry") == [
        ("env-registry", 8), ("env-registry", 9), ("env-registry", 10),
        ("env-registry", 11), ("env-registry", 13)]


@pytest.mark.parametrize("section,missing", [
    ("## PyTorch / CUDA port\n\nRACON_TORCH_FAULT and PYTHONPATH.\n", 0),
    ("## PyTorch / CUDA port\n\nRACON_TORCH_FAULT only.\n"
     "## Next\n\nPYTHONPATH\n", 1),
    ("## Other\n\nRACON_TORCH_FAULT PYTHONPATH\n", 1),
])
def test_knob_docs_fires_exactly(tmp_path, section, missing):
    (tmp_path / "README.md").write_text("# x\n\n" + section)
    rel = _write(tmp_path, "racon_tpu_torch/x.py", "X = 1\n")
    got = lint.run_lint(str(tmp_path), paths=[rel],
                        rules=[RULES_BY_ID["knob-docs"]])
    assert len(got) == missing
    assert all(v.rule == "knob-docs" for v in got)


def test_knob_docs_without_readme(tmp_path):
    rel = _write(tmp_path, "racon_tpu_torch/x.py", "X = 1\n")
    got = lint.run_lint(str(tmp_path), paths=[rel],
                        rules=[RULES_BY_ID["knob-docs"]])
    assert [(v.rule, v.path) for v in got] == [("knob-docs", "README.md")]


FAULT_SNIPPET = """\
from racon_tpu_torch.resilience import faults

def run(kind, point):
    faults.check("poa.run.ls")
    faults.check("poa.run.sl")
    faults.check(f"poa.run.{kind}")
    faults.check(f"pao.run.{kind}")
    faults.check(point)
    faults.check("sanitize.nan", [1])
    faults.check("sanitize.nope")  # lint: disable=fault-point
"""


def test_fault_point_fires_exactly(tmp_path):
    rel = _write(tmp_path, "racon_tpu_torch/ops/fp.py", FAULT_SNIPPET)
    assert _lint(tmp_path, rel, "fault-point") == [
        ("fault-point", 5), ("fault-point", 7)]


EXCEPT_SNIPPET = """\
def f(g):
    try:
        g()
    except:
        pass
    try:
        g()
    except Exception:
        pass
    try:
        g()
    except Exception:  # noqa: BLE001 - a documented seam
        pass
    try:
        g()
    except (ValueError, BaseException) as e:  # noqa: BLE001 - re-raised
        raise RuntimeError("launch") from e
    try:
        g()
    except ValueError:
        pass
"""


@pytest.mark.parametrize("layer,want", [
    # ops/ and parallel/: the marker and a re-raise
    ("ops", [4, 8, 12]),
    ("parallel", [4, 8, 12]),
    # resilience/: the marker alone
    ("resilience", [4, 8]),
    # elsewhere: only the bare except
    ("serve", [4]),
])
def test_device_except_fires_exactly(tmp_path, layer, want):
    rel = _write(tmp_path, f"racon_tpu_torch/{layer}/ex.py", EXCEPT_SNIPPET)
    assert _lint(tmp_path, rel, "device-except") == [
        ("device-except", n) for n in want]


CLOCK_SNIPPET = """\
import time
from time import time as now

def f():
    a = time.time()
    b = now()
    c = time.monotonic()
    d = time.perf_counter()
    e = time.time()  # lint: disable=wall-clock
"""


@pytest.mark.parametrize("layer,want", [("resilience", [5, 6]),
                                        ("obs", [5, 6]), ("ops", [])])
def test_wall_clock_fires_exactly(tmp_path, layer, want):
    rel = _write(tmp_path, f"racon_tpu_torch/{layer}/clock.py",
                 CLOCK_SNIPPET)
    assert _lint(tmp_path, rel, "wall-clock") == [
        ("wall-clock", n) for n in want]


def test_parse_error_is_a_violation(tmp_path):
    rel = _write(tmp_path, "racon_tpu_torch/bad.py", "def f(:\n")
    got = lint.run_lint(str(tmp_path), paths=[rel],
                        rules=[RULES_BY_ID["wall-clock"]])
    assert [(v.rule, v.line) for v in got] == [("parse-error", 1)]


def test_source_files_cover_the_port_and_the_smoke():
    files = lint.iter_source_files(ROOT)
    assert "chip_smoke.py" in files
    assert "racon_tpu_torch/analysis/lint.py" in files
    assert not any(f.startswith("racon_tpu/") or "/_build/" in f or
                   "/build/" in f for f in files)


def test_real_tree_is_clean(real_tree):
    violations, source = real_tree
    assert [v.render() for v in violations] == []
    assert [v.render() for v in source] == []


# ------------------------------------------------------------ source audit

SEEDS = {
    "cuda-float64": (
        "// a double buffer, and 0.5 in a comment\n"
        "__device__ inline double seeded_a(float x) { return x; }\n"
        "__device__ inline float seeded_b(float x) { return x * 0.5; }\n"
        "__device__ inline float seeded_c(float x) { return x * 0.5f + "
        "1e3f; }\n",
        [2, 3]),
    "cuda-host-callback": (
        "static_assert(sizeof(int) == 4, \"printf( assert(\");\n"
        "__device__ inline void seeded_d(int x) {\n"
        "  printf(\"%d\", x);\n"
        "  assert(x > 0);\n"
        "  if (x < 0) __trap();\n"
        "}\n",
        [3, 4, 5]),
}


def _seeded_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(os.path.join(ROOT, build_audit.CSRC), dst)
    return dst


@pytest.mark.parametrize("rule", sorted(SEEDS))
def test_source_rule_fires_on_a_seeded_copy(tmp_path, rule):
    dst = _seeded_csrc(tmp_path)
    text, lines = SEEDS[rule]
    base = (dst / "align.cu").read_text().count("\n")
    with open(dst / "align.cu", "a") as f:
        f.write(text)
    got = build_audit.run_source_audit(ROOT, str(dst))
    assert [(v.rule, v.path, v.line) for v in got] == [
        (rule, "csrc/align.cu", base + n) for n in lines]


def test_cuda_export_fires_both_ways(tmp_path):
    dst = _seeded_csrc(tmp_path)
    src = (dst / "poa.cu").read_text()
    start = src.index("long long rt_poa_layout_bytes(")
    end = src.index("// The card's opt-in shared memory", start)
    (dst / "poa.cu").write_text(
        src[:start] + src[end:] + 'extern "C" int rt_poa_unbound(int x) '
        '{ return x; }\n')
    got = [(v.rule, v.path, v.message.split(",")[0])
           for v in build_audit.run_source_audit(ROOT, str(dst))]
    assert got == [
        ("cuda-export", "csrc/poa.cu",
         "exports rt_poa_unbound"),
        ("cuda-export", "racon_tpu_torch/ops/poa_cuda.py",
         "binds rt_poa_layout_bytes"),
    ]


def test_extern_exports_reads_blocks_and_declarations():
    text = ('// extern "C" { int rt_commented(int); }\n'
            'namespace { int helper(int x) { return x; } }\n'
            'extern "C" {\n'
            'long long rt_a(int n, int (*cb)(int)) { return helper(n); }\n'
            'int rt_b(void) { if (rt_x(1)) { return 1; } return 0; }\n'
            '}  // extern "C"\n'
            'extern "C" int rt_c(int);\n')
    assert build_audit._extern_exports(text) == {"rt_a": 4, "rt_b": 5,
                                                 "rt_c": 7}


# ------------------------------------------------------------------- CLI

REPORTS = {
    "clean": {"sanitize": {"armed": True, "findings": []}},
    "unarmed": {"sanitize": {"armed": False, "findings": []}},
    "findings": {"sanitize": {"armed": True, "findings": [
        {"kind": "parity", "where": "poa._install[ls]",
         "detail": "window 3", "count": 2}]}},
    "no_section": {"phases": {}},
    "not_a_dict": [1, 2],
}


@pytest.mark.parametrize("name", sorted(REPORTS) + ["unreadable",
                                                    "missing"])
@pytest.mark.parametrize("as_json", [False, True])
def test_sanitize_report_exit_codes_equal_jax(tmp_path, capsys, name,
                                              as_json):
    path = tmp_path / "report.json"
    if name == "unreadable":
        path.write_text("{not json")
    elif name != "missing":
        path.write_text(json.dumps(REPORTS[name]))
    argv = ["--sanitize-report", str(path)] + (["--json"] if as_json else [])
    try:
        want = jax_analysis_main(argv)
    except AttributeError:
        want = 2    # the JAX CLI reads a non-dict report no further
    assert analysis_main(argv) == want
    out = capsys.readouterr().out
    if name == "findings" and not as_json:
        assert "SANITIZE FAIL" in out


def test_list_rules(capsys):
    assert analysis_main(["--list-rules"]) == 0
    ids = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert ids[:5] == ["env-registry", "knob-docs", "fault-point",
                       "device-except", "wall-clock"]
    assert {"cuda-float64", "cuda-host-callback", "cuda-export",
            "plan-audit", "plan-variants"} <= set(ids)


def test_baseline_round_trip(tmp_path, capsys):
    rel = _write(tmp_path, "racon_tpu_torch/resilience/clock.py",
                 CLOCK_SNIPPET)
    (tmp_path / "README.md").write_text(
        "## PyTorch / CUDA port\nRACON_TORCH_FAULT PYTHONPATH\n")
    base = str(tmp_path / "baseline.json")
    argv = ["--repo-root", str(tmp_path), "--paths", rel]
    assert analysis_main(argv) == 1
    assert analysis_main(argv + ["--baseline", base,
                                 "--write-baseline"]) == 0
    with open(base) as f:
        # one line-free fingerprint for both time.time() lines
        assert len(json.load(f)["accepted"]) == 1
    assert analysis_main(argv + ["--baseline", base]) == 0
    capsys.readouterr()
    assert analysis_main(argv + ["--baseline", base, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["total"] == 2 and doc["baselined"] == 2 and doc["new"] == []


def test_cli_exit_codes_on_the_tree_and_a_seeded_snippet(tmp_path, capsys):
    assert analysis_main(["--no-lint"]) == 0
    assert "OK: no new violations" in capsys.readouterr().out
    rel = _write(tmp_path, "racon_tpu_torch/ops/fp.py", FAULT_SNIPPET)
    (tmp_path / "README.md").write_text(
        "## PyTorch / CUDA port\nRACON_TORCH_FAULT PYTHONPATH\n")
    assert analysis_main(["--repo-root", str(tmp_path), "--paths",
                          rel]) == 1
    assert "[fault-point]" in capsys.readouterr().out


def test_analysis_imports_no_torch(tmp_path):
    report = tmp_path / "r.json"
    report.write_text(json.dumps(REPORTS["clean"]))
    code = ("import sys\n"
            "import racon_tpu_torch.analysis as a\n"
            "from racon_tpu_torch.analysis.__main__ import main\n"
            "assert a.run_lint() == [] and a.run_source_audit() == []\n"
            f"assert main(['--sanitize-report', {str(report)!r}]) == 0\n"
            "assert main([]) == 0\n"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith(('torch.', 'jax', 'racon_tpu.'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
