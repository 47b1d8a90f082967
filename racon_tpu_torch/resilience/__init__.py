"""Run-time resilience of racon_tpu_torch: the memory budget
(``budget``), fault injection at the port's seams (``faults``), the
crash-safe journal behind ``--journal`` / ``--resume-journal``
(``journal``), the run report behind ``--report`` (``report``) and the
device-wait watchdog (``watchdog``). Copies of the JAX package's
modules of the same names, without its degradation lattice."""
