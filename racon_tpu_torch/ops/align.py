"""Alignment op-path helpers shared by the aligner engines."""

import numpy as np

_OPC = np.frombuffer(b"MID", dtype=np.uint8)


def ops_to_cigar(ops: np.ndarray) -> str:
    """Run-length encode forward-ordered op codes (0=M,1=I,2=D)."""
    if len(ops) == 0:
        return ""
    change = np.nonzero(np.diff(ops))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [len(ops)]])
    out = []
    for s, e in zip(starts, ends):
        out.append(f"{e - s}{chr(_OPC[ops[s]])}")
    return "".join(out)
