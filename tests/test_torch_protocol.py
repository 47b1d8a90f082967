"""The port's protocol model checker (racon_tpu_torch/analysis/protocol)
and the ``fault-model`` contract, against the JAX package's
(racon_tpu/analysis/protocol), on the CPU.

* Held against the JAX model: off the card the port's checker explores
  the JAX checker's states and transitions with its verdict, on a small
  config (each engine once, in a module fixture), and its witness trace
  is the JAX one; each JAX mutation scenario names the port's mutation
  with the same invariant and config; the JAX conformance and
  ``fault-model`` fixtures, copied to tmp_path with ``racon_tpu/``
  renamed ``racon_tpu_torch/`` (the fault-model tree's drill and docs
  stubs in the port's form), give the JAX rule once at the same line.
* The model itself: the default config exhausted and clean on the card
  and off it (one exploration a mode, in a module fixture);
  ``successors`` implements exactly ``TRANSITIONS``, with ``fail_job``
  reached on the card and ``local_floor`` only off it; every mutation
  caught in each mode that reaches it.
* Conformance and ``fault-model`` on the real tree are clean; schedules
  compile to specs the port's ``parse_spec`` accepts, the witness with
  ``fault_worker`` 0; the CLI's exit codes are the JAX CLI's.
* The model's port-side points: a raise at ``poa.run.ls`` in a worker's
  chunk reaches ``FleetPlane._chunk_error`` and the worker lives on (a
  worker in a thread); and the one test that starts worker processes:
  the witness schedule replayed on a CPU fleet of two workers.
"""

import glob
import json
import os

import pytest
import torch

from racon_tpu.analysis.__main__ import main as jax_analysis_main
from racon_tpu.analysis.concurrency import contracts as jax_contracts
from racon_tpu.analysis.protocol import checker as jax_checker
from racon_tpu.analysis.protocol import conformance as jax_conformance
from racon_tpu.analysis.protocol import replay as jax_replay
from racon_tpu.analysis.protocol.model import Config as JaxConfig
from racon_tpu_torch import create_polisher
from racon_tpu_torch.analysis.__main__ import main as analysis_main
from racon_tpu_torch.analysis.concurrency import contracts
from racon_tpu_torch.analysis.protocol import (checker, conformance,
                                               replay)
from racon_tpu_torch.analysis.protocol import invariants as inv
from racon_tpu_torch.analysis.protocol.model import (Config, MUTATIONS,
                                                     TRANSITIONS, initial,
                                                     mutation_entry,
                                                     successors,
                                                     transition_names)
from racon_tpu_torch.distrib import Coordinator, worker
from racon_tpu_torch.fleet.plane import FleetPlane
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.tools import simulate
from tests.test_torch_distrib import ThreadProc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXROOT = os.path.join(ROOT, "tests", "analysis_fixtures", "protocol")
CONCROOT = os.path.join(ROOT, "tests", "analysis_fixtures", "concurrency")
KW = dict(window_length=100, match=5, mismatch=-4, gap=-8)
WAIT = 120   # seconds: every run's and wait's deadline
SMALL = dict(chunks=("A", "A"), submit_ests=(2,))
# the mutations' config: two submitters, so that the admission race is
# reachable, and two chunks, so that each graph check stays small
MUT = dict(chunks=("A", "A"), submit_ests=(2, 2))
MODES = {"card": True, "off_card": False}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No fault armed; one torch thread."""
    torch.set_num_threads(1)
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.configure(None)
    yield
    faults.configure(None)


def _swap(text):
    return text.replace("racon_tpu/", "racon_tpu_torch/").replace(
        "racon_tpu.", "racon_tpu_torch.")


def _port_copy(name, dest):
    """The JAX fixture tree `name` under dest, racon_tpu/ renamed
    racon_tpu_torch/ in its paths and its text (the originals are only
    read)."""
    src = os.path.join(FIXROOT, name)
    for path in glob.glob(os.path.join(src, "racon_tpu", "**", "*.py"),
                          recursive=True):
        rel = _swap(os.path.relpath(path, src))
        out = os.path.join(str(dest), rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(path) as f, open(out, "w") as g:
            g.write(_swap(f.read()))
    return str(dest)


def _rows(vs):
    return [(v.rule, _swap(v.path), v.line, _swap(v.message)) for v in vs]


# -- the bounded space ------------------------------------------------------

@pytest.fixture(scope="module")
def explored():
    """One exploration of the default config a mode, and the event names
    a shallow sweep of each mode fires."""
    out = {}
    for mode, card in MODES.items():
        cfg = Config(card=card)
        res = checker.check(cfg, stop_on_first=False)
        names, seen, frontier = set(), {initial(cfg)}, [initial(cfg)]
        for _ in range(14):
            nxt = []
            for s in frontier:
                for ev, ns in successors(cfg, s, None):
                    names.add(ev[0])
                    if ns not in seen and len(seen) < 60_000:
                        seen.add(ns)
                        nxt.append(ns)
            frontier = nxt
        out[mode] = (res, names)
    return out


@pytest.fixture(scope="module")
def small_pair():
    """The port's checker off the card and the JAX checker on one small
    config, each once."""
    port = checker.check(Config(card=False, **SMALL), stop_on_first=False)
    jax = jax_checker.check(JaxConfig(**SMALL), stop_on_first=False)
    return port, jax


def test_off_card_explores_the_jax_space(small_pair):
    port, jax = small_pair
    assert (port.states, port.transitions, port.ok, port.exhausted) == (
        jax.states, jax.transitions, jax.ok, jax.exhausted)
    assert port.exhausted and port.ok


@pytest.mark.parametrize("mode", MODES)
def test_default_config_exhausted_and_clean(explored, mode):
    res, _ = explored[mode]
    assert res.exhausted, "the default config must be fully explored"
    assert res.ok, "\n".join(v.render() for v in res.violations)
    assert res.config.card is MODES[mode]


def test_off_card_default_space_is_the_jax_size(explored):
    # the JAX checker's default space (racon_tpu/analysis/protocol)
    res, _ = explored["off_card"]
    assert (res.states, res.transitions) == (283_820, 1_048_937)


def test_successors_implement_exactly_the_declared_transitions(explored):
    fired = explored["card"][1] | explored["off_card"][1]
    declared = set(transition_names())
    assert fired == declared, (
        f"model drift: declared-but-never-fired="
        f"{sorted(declared - fired)}, fired-but-undeclared="
        f"{sorted(fired - declared)}")


@pytest.mark.parametrize("mode", MODES)
def test_fail_job_on_the_card_and_local_floor_off_it(explored, mode):
    names = explored[mode][1]
    if MODES[mode]:
        assert "fail_job" in names and "local_floor" not in names
    else:
        assert "local_floor" in names and "fail_job" not in names


def test_declared_fault_points_cover_every_fleet_scoped_point():
    claimed = {t[3] for t in TRANSITIONS if t[3] is not None}
    fleet = {p for p in faults.KNOWN_POINTS
             if p.startswith(conformance.FLEET_PREFIXES)}
    assert fleet <= claimed, sorted(fleet - claimed)
    assert claimed <= faults.KNOWN_POINTS, sorted(
        claimed - faults.KNOWN_POINTS)
    sites = {t[0]: (t[1], t[2], t[3]) for t in TRANSITIONS}
    assert sites["deliver_error"] == ("racon_tpu_torch/fleet/plane.py",
                                      "_chunk_error", "poa.run.ls")
    assert sites["fail_job"] == ("racon_tpu_torch/fleet/plane.py",
                                 "_to_local", None)


# -- the seeded mutations ---------------------------------------------------

_SCENARIOS = sorted(glob.glob(os.path.join(FIXROOT, "invariants",
                                           "*.json")))


@pytest.mark.parametrize("path", _SCENARIOS,
                         ids=[os.path.basename(p) for p in _SCENARIOS])
def test_jax_scenario_names_the_ports_mutation(path):
    with open(path) as f:
        scen = json.load(f)
    _name, _doc, expected, overrides = mutation_entry(scen["mutation"])
    assert expected == scen["invariant"]
    assert overrides == scen["config"]


def test_every_invariant_has_a_mutation():
    assert {m[2] for m in MUTATIONS} == set(inv.invariant_names())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mutation", [m[0] for m in MUTATIONS])
def test_every_mutation_is_caught_where_reached(mutation, mode):
    res = checker.check(Config(card=MODES[mode], **MUT), mutation=mutation)
    expected = mutation_entry(mutation)[2]
    got = {v.invariant for v in res.violations}
    if mutation == "failed-job-gathers" and mode == "off_card":
        # off the card no job fails: the flipped guard is never reached
        assert res.ok and res.exhausted
        return
    assert got == {expected}, (mutation, mode, got)
    assert all(v.trace for v in res.violations
               if v.invariant != inv.QUIESCENCE)


def test_dfs_fallback_finds_safety_violations():
    res = checker.check(mutation="expiry-releases-journal",
                        strategy="dfs", depth=12)
    assert any(v.invariant == inv.ONE_CANONICAL for v in res.violations)


# -- conformance and fault-model --------------------------------------------

@pytest.mark.parametrize("tree,rule", [
    ("badsite", "model-site"),
    ("badfault", "model-fault"),
    ("uncovered", "model-coverage"),
])
def test_conformance_fixture_equals_jax(tmp_path, tree, rule):
    want = _rows(jax_conformance.audit(os.path.join(FIXROOT, tree)))
    got = _rows(conformance.audit(_port_copy(tree, tmp_path)))
    assert got == want and [r[0] for r in got] == [rule]


def test_fault_model_fixture_equals_jax(tmp_path):
    """The JAX tree's drill (tests/drills.py) and docs row
    (docs/failures.md) in the port's form: a port test and a row of
    README.md's port section."""
    want = _rows(jax_contracts.audit(os.path.join(FIXROOT, "faultmodel")))
    root = _port_copy("faultmodel", tmp_path)
    os.makedirs(os.path.join(root, "tests"))
    with open(os.path.join(FIXROOT, "faultmodel", "tests",
                           "drills.py")) as f, \
            open(os.path.join(root, "tests", "test_torch_drills.py"),
                 "w") as g:
        g.write(f.read())
    with open(os.path.join(FIXROOT, "faultmodel", "docs",
                           "failures.md")) as f:
        rows = f.read().split("\n", 1)[1]
    with open(os.path.join(root, "README.md"), "w") as g:
        g.write("## PyTorch / CUDA port\n" + rows)
    got = _rows(contracts.audit(root))
    assert got == want and [r[0] for r in got] == ["fault-model"]
    assert "pool.steal" in got[0][3]


def test_real_tree_conformance_and_fault_model_clean():
    assert [v.render() for v in conformance.audit(ROOT)] == []
    assert [v.render() for v in contracts._fault_model_checks(ROOT)] == []


def test_trees_without_a_model_are_skipped():
    races = os.path.join(CONCROOT, "races")
    assert conformance.audit(races) == []
    assert contracts._fault_model_checks(races) == []


# -- schedules --------------------------------------------------------------

def test_counterexample_compiles_to_a_valid_fault_schedule():
    res = checker.check(Config(**MUT), mutation="reclaim-skips-requeue")
    sched = replay.compile_trace(res.violations[0].trace)
    assert sched.spec and faults.parse_spec(sched.spec)
    assert "worker_die" in sched.events
    assert sched.kwargs() == {"fault_worker": sched.worker}
    assert sched.env() == {faults.ENV: sched.spec}


def test_deliver_error_compiles_to_the_poa_run_point():
    sched = replay.compile_trace([("dispatch", (0, 1)),
                                  ("deliver_error", (0, 1))])
    assert sched.spec == "poa.run.ls:raise=RuntimeError:count=1"
    assert sched.kwargs() == {"fault_worker": 1}
    assert faults.parse_spec(sched.spec)[0].point == "poa.run.ls"


def test_two_worker_scopes_are_unreplayable():
    with pytest.raises(replay.Unreplayable):
        replay.compile_trace([("worker_die", (0,)), ("worker_die", (1,))])


def test_witness_compiles_with_fault_worker_zero():
    trace, sched = replay.witness_trace()
    names = [ev[0] for ev in trace]
    assert "worker_die" in names and "lease_reclaim" in names
    assert names[-1] == "gather" and "fail_job" not in names
    assert sched.events == ("worker_die",)
    assert [s.point for s in faults.parse_spec(sched.spec)] == [
        "worker.result"]
    assert sched.kwargs() == {"fault_worker": 0}
    assert sched.env() == {"RACON_TORCH_FAULT": sched.spec}


def test_witness_off_the_card_is_the_jax_witness():
    trace, sched = replay.witness_trace(
        Config(chunks=("A", "A", "A"), submit_ests=(2,), card=False))
    jtrace, jsched = jax_replay.witness_trace()
    assert trace == jtrace
    assert (sched.spec, sched.worker, sched.events) == (
        jsched.spec, jsched.worker, jsched.events)


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--model-check", "--mc-chunks", "A,A", "--mc-submits", "2"],
    ["--mutate", "split-check-reserve"],
    ["--mutate", "1"],
    ["--model-check", "--mc-max-states", "50"],
    ["--list-mutations"],
], ids=["clean", "caught", "by-index", "partial", "list"])
def test_cli_exit_code_equals_jax(argv, capsys):
    want = jax_analysis_main(argv)
    capsys.readouterr()
    args = argv + (["--mc-off-card"] if argv[0] == "--model-check" else [])
    assert analysis_main(args) == want
    assert analysis_main(argv) == want      # on the card too


def test_cli_unknown_mutation_is_refused(capsys):
    assert analysis_main(["--mutate", "no-such-mutation"]) == 2
    assert "unknown mutation" in capsys.readouterr().err


def test_cli_emit_schedule_and_json(tmp_path, capsys):
    dest = str(tmp_path / "sched.json")
    rc = analysis_main(["--mutate", "expiry-releases-journal",
                        "--emit-schedule", dest, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["model_check"]["mutation"] == "expiry-releases-journal"
    assert doc["model_check"]["invariants"] == [inv.ONE_CANONICAL]
    assert doc["model_check"]["card"] is True
    with open(dest) as f:
        payload = json.load(f)
    # a pure-timing counterexample: nothing to inject
    assert payload["source"] == inv.ONE_CANONICAL and payload["trace"]
    assert payload["spec"] == "" and payload["env"] == {}
    assert payload["kwargs"] == {}
    assert analysis_main(["--model-check", "--mc-chunks", "A,A",
                          "--mc-submits", "2", "--emit-schedule", "-"]) \
        == 0
    out = capsys.readouterr().out
    witness = json.loads(out[:out.rindex("}") + 1])
    assert witness["source"] == "witness"
    assert witness["kwargs"] == {"fault_worker": 0}


def test_cli_list_rules_names_the_new_rules(capsys):
    assert analysis_main(["--list-rules"]) == 0
    ids = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}
    assert {"fault-model", "model-site", "model-fault", "model-coverage",
            "protocol-invariant", "determinism-leak", "fingerprint-gap",
            "fingerprint-overkey"} <= ids


# -- the model's points in the fleet ----------------------------------------

def _fasta(records):
    return "".join(f">{n}\n{s}\n" for n, s in records)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """A three-contig set and its sequential polish on the CPU."""
    torch.set_num_threads(1)
    d = simulate.generate(str(tmp_path_factory.mktemp("protocol")),
                          mbp=0.003, contigs=3)
    paths = (d["reads"], d["overlaps"], d["draft"])
    p = create_polisher(*paths, device="cpu", **KW)
    p.initialize()
    return paths, _fasta(p.polish(True))


def test_poa_run_raise_reaches_chunk_error_not_a_worker_exit(
        sim, tmp_path, monkeypatch):
    """deliver_error's point: the first chunk worker 0 polishes raises at
    poa.run.ls; the worker reports it (FleetPlane._chunk_error), lives
    on, and polishes the chunk again with the sequential bytes."""
    paths, seq = sim
    spec = replay.compile_trace([("dispatch", (0, 0)),
                                 ("deliver_error", (0, 0))])
    assert spec.kwargs() == {"fault_worker": 0}
    errors, polished = [], []
    real_error, real_polish = FleetPlane._chunk_error, worker._polish_chunk

    def chunk_error(self, req):
        errors.append(req)
        return real_error(self, req)

    def polish(a, **kw):
        # the schedule armed for the worker's first chunk alone (each
        # polisher starts its fault counts afresh)
        faults.configure(spec.spec if not polished else None)
        polished.append(a["index"])
        return real_polish(a, **kw)

    monkeypatch.setattr(FleetPlane, "_chunk_error", chunk_error)
    monkeypatch.setattr(worker, "_polish_chunk", polish)
    plane = FleetPlane(str(tmp_path / "plane"), min_workers=1,
                       max_workers=1, retry_base=0.01, max_retries=1,
                       device="cpu", spawn=ThreadProc, **spec.kwargs())
    plane.start()
    try:
        job = plane.submit_job("J", *paths, dict(KW), False, "cuda",
                               str(tmp_path / "wd"))
        assert job.done.wait(WAIT)
        procs = list(plane.pool._procs.values())
        alive = [p.poll() is None for p in procs]
    finally:
        plane.stop(timeout=WAIT)
    assert job.state == "done", job.error
    with open(job.result["output"]) as f:
        assert f.read() == seq
    assert len(errors) == 1 and errors[0]["worker"] == 0
    assert "injected fault at poa.run.ls" in errors[0]["error"]
    assert plane.counters.get("workers_dead", 0) == 0
    assert alive == [True]
    assert polished.count(polished[0]) == 2


def test_witness_schedule_replays_on_a_two_worker_fleet(sim, tmp_path,
                                                        monkeypatch):
    """The model-to-fleet bridge: the shortest clean run through
    worker_die and lease_reclaim compiles to a RACON_TORCH_FAULT spec and
    its fault_worker; replayed on two worker processes, worker 0 dies at
    its first result, its chunk is reclaimed and resumed from its journal,
    and the job gathers the sequential bytes once."""
    paths, seq = sim
    _, sched = replay.witness_trace()
    assert sched.events == ("worker_die",)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for key, val in sched.env().items():
        monkeypatch.setenv(key, val)
    out = str(tmp_path / "out.fasta")
    coord = Coordinator(*paths, str(tmp_path / "coord"), args=dict(KW),
                        backend="cuda", device="cpu", workers=2,
                        retry_base=0.01, **sched.kwargs())
    res = coord.run(out, timeout=WAIT)
    with open(out) as f:
        assert f.read() == seq
    assert res["counters"]["workers_dead"] >= 1
    # every chunk accepted once, from the fleet
    assert res["served"] == {"fleet": 3, "local": 0}
    assert sorted(r["index"] for r in res["chunk_stats"]) == [0, 1, 2]
    redone = [r for r in res["chunk_stats"] if r["attempts"] > 1]
    assert redone and all(r["worker"] == 1 and r["journal_replayed"] > 0
                          for r in redone)
