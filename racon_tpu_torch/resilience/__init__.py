"""Run-time resilience of racon_tpu_torch: the memory budget
(``budget.MemoryBudget``)."""
