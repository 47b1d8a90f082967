"""The native sanitizer matrix of the port's host runtime
(racon_tpu_torch/native: test/rt_test.cpp, test/rt_stress.cpp, the
suppression files and the Makefile's test, stress, lint, debug, asan, tsan
and ubsan targets).

* ``make tsan`` builds the instrumented library, rt_test and rt_stress
  into a build directory under tmp_path (``BUILD=``) and runs both clean
  under ThreadSanitizer (the one subprocess, with a 300 s timeout).
* The suppression files hold no entry, the harness names the port's
  runtime, and the Makefile keeps ``all`` (the library and the native
  CLI binary) as its default target, the binary's main in its lint gate
  and every sanitizer build out of ``build/``.
"""

import os
import re
import shutil
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "racon_tpu_torch", "native")
TARGETS = ("test", "stress", "lint", "debug", "asan", "tsan", "ubsan")


def _read(*parts):
    with open(os.path.join(NATIVE, *parts)) as f:
        return f.read()


def test_tsan_matrix_runs_clean(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.fail("make and g++ are needed to build the native runtime")
    r = subprocess.run(["make", "-C", NATIVE, "-j4", "tsan",
                        f"BUILD={tmp_path}/b"],
                       capture_output=True, text=True, timeout=300)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert re.search(r"^all \d+ checks passed$", out, re.M), out[-4000:]
    assert re.search(r"^all \d+ stress checks passed$", out, re.M), \
        out[-4000:]
    assert "WARNING: ThreadSanitizer" not in out
    assert os.path.exists(tmp_path / "b-tsan" / "libracon_host.so")
    assert not os.path.exists(tmp_path / "b")   # the production tree


@pytest.mark.parametrize("name", ["tsan.supp", "lsan.supp", "ubsan.supp"])
def test_suppression_files_hold_no_entry(name):
    entries = [ln for ln in _read("test", name).splitlines()
               if ln.strip() and not ln.lstrip().startswith("#")]
    assert entries == []


@pytest.mark.parametrize("name", ["rt_test.cpp", "rt_stress.cpp"])
def test_harness_names_the_ports_runtime(name):
    text = _read("test", name)
    assert "make -C racon_tpu_torch/native " in text
    assert "racon_tpu/native" not in text
    for inc in re.findall(r'#include "\.\./src/(\w+\.hpp)"', text):
        assert os.path.exists(os.path.join(NATIVE, "src", inc)), inc


def test_makefile_targets():
    mk = _read("Makefile")
    first = re.search(r"^([\w$()./-]+):", mk, re.M).group(1)
    assert first == "all"
    assert re.search(r"^all: \$\(BUILD\)/libracon_host\.so "
                     r"\$\(BUILD\)/racon_tpu_torch$", mk, re.M)
    for t in TARGETS:
        assert re.search(rf"^{t}:", mk, re.M), t
    for mode in ("asan", "tsan", "ubsan"):
        assert f"BUILD=$(BUILD)-{mode}" in mk
    # the native CLI binary: its target, and its main in the lint gate
    assert re.search(r"^\$\(BUILD\)/racon_tpu_torch: .*rt_main\.o$", mk,
                     re.M)
    assert re.search(r"^lint:\n\t.*src/rt_main\.cpp", mk, re.M)
