"""Read a cost-model machine profile's fitted rates where it runs.

    python -m racon_tpu_torch.tools.fit_profile cpu-host|h100

Each profile of obs/costmodel.py is read on one fixed set, three runs,
each a traced polish of the set (TorchPolisher, `-w 500 -m 5 -x -4 -g
-8`) and a polish of it with the host backend; one JSON line gives each
run's readings and, per rate, the median, least and largest:

* ``cpu-host``: a 0.01 Mbp set (tools/simulate.py, 10x, seed 11) on the
  CPU (the kernels' plain PyTorch versions, one torch thread; the host
  backend on one thread). Every device rate is fitted so that each term
  explains its phase: ``serial_step_s`` is phase.poa's wall over the POA
  serial steps, ``peak_flops`` the POA integer ops over that wall, and
  ``align_step_cells`` the Hirschberg cells a serial step over
  phase.align's wall.
* ``h100``: the smoke's main cell (1.0 Mbp, 30x, seed 11) on the card
  (the host backend on every core). The peaks and ``serial_step_s`` are
  not fitted (the data sheet and the DP-cost probe);
  ``align_step_cells`` is the Hirschberg cells of the profile's serial
  step at the rate of the aligner's kernels, their cells over the edge
  and base-case kernels' busy time on the trace's device track, so that
  the aligner's serial term bills the card's own aligner time.

Host rates, both profiles: ``host_poa_cells_per_s`` is the model's POA
cells over the host backend's consensus seconds;
``host_align_cells_per_s`` is ``align.cells.total`` over its initialize
seconds (one native call that parses, aligns and builds the windows, so
a lower bound on the aligner's rate).
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import tempfile

from ..obs import costmodel

_POA_CELLS = re.compile(r"^poa\.cells\.d(\d+)\.c(\d+)$")

#: profile -> the set and the machine it is read on
SETS = {
    "cpu-host": dict(device="cpu", mbp=0.01, coverage=10, threads=1),
    "h100": dict(device="cuda", mbp=1.0, coverage=30,
                 threads=os.cpu_count()),
}
RUNS = 3
KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)


def poa_work(counters: dict) -> dict:
    """The POA phase's integer ops and serial steps the cost model bills
    from `counters`, on one device."""
    inf = float("inf")
    unit = dict(name="unit", description="", clock_hz=1.0, peak_flops=inf,
                hbm_bytes_per_s=inf, serial_step_s=0.0, align_step_cells=1.0,
                host_poa_cells_per_s=inf, host_align_cells_per_s=inf,
                error_bound_ratio=1.0)
    out = {}
    for term, rate in (("ops", dict(peak_flops=1.0)),
                       ("serial_steps", dict(serial_step_s=1.0))):
        prof = costmodel.MachineProfile(**{**unit, **rate})
        out[term] = costmodel.predict_from_counters(
            counters, prof, n_devices=1)["phases"]["poa"]["predicted_s"]
    return out


def poa_model_cells(counters: dict) -> float:
    """The model's POA cells: per bucket, sum(depth) x class (the counter)
    x NODE_GROWTH x class."""
    cells = 0.0
    for name, raw in counters.items():
        m = _POA_CELLS.match(name)
        if m:
            cells += float(raw) * costmodel.NODE_GROWTH * int(m.group(2))
    return cells


def readings(name: str, doc: dict, host_stats: dict) -> dict:
    """One run's rates for profile `name`: its traced polish (`doc`) and
    the host backend's stats (CpuPolisher.stats)."""
    from ..obs.__main__ import device_track, phase_walls_us

    counters = doc["racon_tpu"]["metrics"]["counters"]
    walls = {k: v / 1e6 for k, v in phase_walls_us(doc).items()}
    cells = counters["align.cells.hirschberg"]
    out = {"phase_s": walls, "align_cells_hirschberg": cells,
           "host_stats": host_stats,
           "host_poa_cells_per_s":
           poa_model_cells(counters) / host_stats["consensus_s"],
           "host_align_cells_per_s":
           counters["align.cells.total"] / host_stats["initialize_s"]}
    if name == "cpu-host":
        work = poa_work(counters)
        step = walls["poa"] / work["serial_steps"]
        out.update(serial_step_s=step, peak_flops=work["ops"] / walls["poa"],
                   align_step_cells=cells * step / walls["align"])
    else:
        busy = sum(k["busy_us"] for n, k in device_track(doc)["kernels"]
                   .items() if n.startswith("hirschberg")) / 1e6
        out.update(aligner_device_s=busy, align_step_cells=cells *
                   costmodel.profile(name).serial_step_s / busy)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] not in SETS:
        print(f"usage: python -m racon_tpu_torch.tools.fit_profile "
              f"{'|'.join(SETS)}", file=sys.stderr)
        return 2
    name = argv[0]
    cfg = SETS[name]

    import torch

    from .. import create_polisher
    from . import simulate

    if cfg["device"] == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        print("fit_profile: the h100 profile is read on the card, and "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    runs = []
    with tempfile.TemporaryDirectory(prefix="fit_profile_") as tmp:
        d = simulate.generate(os.path.join(tmp, "set"), mbp=cfg["mbp"],
                              coverage=cfg["coverage"], seed=11)
        inputs = (d["reads"], d["overlaps"], d["draft"])
        for i in range(RUNS):
            trace = os.path.join(tmp, f"trace{i}.json")
            p = create_polisher(*inputs, device=cfg["device"],
                                trace_path=trace, **KW)
            p.initialize()
            p.polish(True)
            h = create_polisher(*inputs, backend="host",
                                num_threads=cfg["threads"], **KW)
            h.initialize()
            h.polish(True)
            with open(trace) as f:
                runs.append(readings(name, json.load(f), h.stats))
    rates = {k: {"median": statistics.median(r[k] for r in runs),
                 "min": min(r[k] for r in runs),
                 "max": max(r[k] for r in runs)}
             for k, v in runs[0].items() if isinstance(v, float)}
    out = {"profile": name, **cfg, "runs": runs, "rates": rates}
    if cfg["device"] == "cuda":
        from .kernel_bench import nvidia_smi
        out["card"] = nvidia_smi()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
