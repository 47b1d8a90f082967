"""Synthetic long-read polishing workload generator.

Produces a (genome, draft, reads FASTQ, overlaps PAF) quadruple with an
ONT-like error profile so benchmarks and scale tests can run at arbitrary
genome sizes without external data. The draft is a substitution-mutated copy
of the genome (so PAF coordinates transfer 1:1), reads carry
substitution/insertion/deletion errors at configurable rates, and overlaps
are emitted from simulation truth.

Usage:
    python -m racon_tpu_torch.tools.simulate -o OUTDIR --mbp 1.0 --coverage 30
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


_OP_CHARS = np.frombuffer(b"MDI", dtype=np.uint8)


def _cigar_from_ops(ops: np.ndarray, start: int, end: int):
    """RLE an op-code array (0=M, 1=D, 2=I) into a CIGAR string, clipping
    leading/trailing deletion runs (invalid in SAM) by moving the target
    coordinates inward. Returns (cigar, start, end)."""
    # clip boundary D runs
    lo = 0
    while lo < len(ops) and ops[lo] == 1:
        lo += 1
    hi = len(ops)
    while hi > lo and ops[hi - 1] == 1:
        hi -= 1
    start += lo
    end -= len(ops) - hi
    ops = ops[lo:hi]
    if not len(ops):
        return "", start, end
    bounds = np.nonzero(np.diff(ops))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(ops)]])
    cigar = "".join(f"{e - s}{chr(_OP_CHARS[ops[s]])}"
                    for s, e in zip(starts, ends))
    return cigar, start, end


def _mutate_reads(genome: np.ndarray, rng, n_reads: int, mean_len: int,
                  sub: float, ins: float, dele: float):
    """Yield (start, end, strand, read_bytes, fwd_bytes, cigar) tuples.

    fwd_bytes is the read in target orientation (what a SAM record's SEQ
    column carries for a reverse-strand read), cigar the true alignment of
    fwd_bytes to the target — both from simulation ground truth.
    """
    g_len = len(genome)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    for _ in range(n_reads):
        # floor at min(500, mean): the 500 floor suits long-read gammas;
        # short-read profiles (mean 150) would otherwise clamp every
        # read up to 500
        lo = min(500, int(mean_len))
        length = int(np.clip(rng.gamma(4.0, mean_len / 4.0), lo, 40000))
        length = min(length, g_len)
        start = int(rng.integers(0, g_len - length + 1))
        seg = genome[start:start + length]

        r = rng.random(length)
        # substitutions
        sub_mask = r < sub
        seg = seg.copy()
        seg[sub_mask] = BASES[rng.integers(0, 4, int(sub_mask.sum()))]
        # deletions
        keep = rng.random(length) >= dele
        seg = seg[keep]
        # insertions (after random positions)
        ins_mask = rng.random(len(seg)) < ins
        n_ins = int(ins_mask.sum())
        if n_ins:
            out = np.empty(len(seg) + n_ins, dtype=np.uint8)
            pos = np.nonzero(ins_mask)[0]
            out_idx = np.arange(len(seg)) + np.cumsum(ins_mask) - ins_mask
            out[out_idx] = seg
            ins_at = pos + np.arange(1, n_ins + 1)
            out[ins_at] = BASES[rng.integers(0, 4, n_ins)]
            seg = out

        # true op stream in target orientation: M/D per genome position,
        # with each I scattered after its (post-deletion) M
        ops_orig = np.where(keep, 0, 1).astype(np.uint8)
        ins_after = np.zeros(length, dtype=np.int64)
        if n_ins:
            ins_after[np.nonzero(keep)[0]] = ins_mask.astype(np.int64)
        shift = np.concatenate([[0], np.cumsum(ins_after)[:-1]])
        ops = np.full(length + int(ins_after.sum()), 2, dtype=np.uint8)
        ops[np.arange(length) + shift] = ops_orig
        cigar, cg_start, cg_end = _cigar_from_ops(ops, start, start + length)

        strand = bool(rng.integers(0, 2))
        fwd = seg
        if strand:
            seg = comp[seg][::-1]
        yield start, start + length, strand, seg, fwd, (cigar, cg_start,
                                                        cg_end)


def generate(outdir: str, mbp: float = 1.0, coverage: int = 30,
             mean_read: int = 8000, sub: float = 0.05, ins: float = 0.03,
             dele: float = 0.03, draft_error: float = 0.01,
             seed: int = 11, contigs: int = 1) -> dict:
    """`contigs` > 1 splits the genome into that many contiguous draft
    contigs (contig0..contigN-1, per-contig PAF/SAM coordinates, one @SQ
    line each) — the multi-contig shape the phase-pipelined polisher
    chunks on.  The default single-contig output is byte-identical to
    what this generator always produced (name 'contig', same rng
    stream)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    g_len = int(mbp * 1e6)

    genome = BASES[rng.integers(0, 4, g_len)]
    draft = genome.copy()
    derr = rng.random(g_len) < draft_error
    draft[derr] = BASES[rng.integers(0, 4, int(derr.sum()))]

    k = max(1, min(int(contigs), g_len))
    bounds = np.linspace(0, g_len, k + 1).astype(int)
    names = ["contig"] if k == 1 else [f"contig{ci}" for ci in range(k)]

    paths = {
        "genome": os.path.join(outdir, "genome.fasta"),
        "draft": os.path.join(outdir, "draft.fasta"),
        "reads": os.path.join(outdir, "reads.fastq"),
        "overlaps": os.path.join(outdir, "overlaps.paf"),
        "overlaps_sam": os.path.join(outdir, "overlaps.sam"),
    }

    with open(paths["genome"], "w") as f:
        f.write(">genome\n")
        f.write(genome.tobytes().decode())
        f.write("\n")
    with open(paths["draft"], "w") as f:
        for ci, name in enumerate(names):
            f.write(f">{name}\n")
            f.write(draft[bounds[ci]:bounds[ci + 1]].tobytes().decode())
            f.write("\n")

    qual_char = chr(33 + 15)
    with open(paths["reads"], "w") as rf, \
            open(paths["overlaps"], "w") as of, \
            open(paths["overlaps_sam"], "w") as sf:
        sf.write("@HD\tVN:1.6\tSO:unsorted\n")
        for ci, name in enumerate(names):
            sf.write(f"@SQ\tSN:{name}\tLN:{bounds[ci + 1] - bounds[ci]}\n")
        i = 0   # read numbering is global across contigs
        for ci, tname in enumerate(names):
            seg_genome = genome[bounds[ci]:bounds[ci + 1]]
            t_len = len(seg_genome)
            n_reads = max(1, int(t_len * coverage / mean_read))
            for start, end, strand, seg, fwd, cg in _mutate_reads(
                    seg_genome, rng, n_reads, mean_read, sub, ins, dele):
                name = f"read{i}"
                i += 1
                rf.write(f"@{name}\n{seg.tobytes().decode()}\n+\n"
                         f"{qual_char * len(seg)}\n")
                of.write(f"{name}\t{len(seg)}\t0\t{len(seg)}\t"
                         f"{'-' if strand else '+'}\t{tname}\t{t_len}\t"
                         f"{start}\t{end}\t{min(len(seg), end - start)}\t"
                         f"{max(len(seg), end - start)}\t60\n")
                # SAM record with the TRUE alignment (what minimap2 -a
                # would approximate): SEQ in target orientation,
                # ground-truth CIGAR
                cigar, cg_start, _cg_end = cg
                flag = 16 if strand else 0
                sf.write(f"{name}\t{flag}\t{tname}\t{cg_start + 1}\t60\t"
                         f"{cigar}\t*\t0\t0\t{fwd.tobytes().decode()}\t"
                         f"{qual_char * len(fwd)}\n")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="racon-tpu-torch-simulate",
                                description=__doc__.splitlines()[0])
    p.add_argument("-o", "--out-directory", required=True)
    p.add_argument("--mbp", type=float, default=1.0)
    p.add_argument("--coverage", type=int, default=30)
    p.add_argument("--mean-read", type=int, default=8000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--contigs", type=int, default=1,
                   help="split the genome into this many draft contigs "
                        "(default 1; >1 enables phase-pipelined polishing)")
    args = p.parse_args(argv)
    paths = generate(args.out_directory, mbp=args.mbp,
                     coverage=args.coverage, mean_read=args.mean_read,
                     seed=args.seed, contigs=args.contigs)
    for k, v in paths.items():
        print(f"{k}: {v}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
