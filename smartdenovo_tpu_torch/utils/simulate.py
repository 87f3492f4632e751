"""Synthetic noisy long-read simulator for tests and benchmarks.

The reference ships no automated tests (SURVEY.md §4); golden acceptance is
an end-to-end E. coli run.  We create the test pyramid ourselves: simulate
a genome, sample noisy reads (PacBio-like indel-heavy error profile),
assemble, and check the assembly reconstructs the genome.
"""

from __future__ import annotations

import numpy as np


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def mutate_read(rng: np.random.Generator, seq: np.ndarray, err: float,
                sub_frac: float = 0.15, ins_frac: float = 0.55, del_frac: float = 0.30,
                hp_bias: float = 0.75) -> np.ndarray:
    """Apply a PacBio-like error profile.

    Raw PacBio/ONT errors are indel-dominated and strongly homopolymer-
    biased — most length errors extend or shorten homopolymer runs.  This
    is exactly why the reference assembler indexes homopolymer-compressed
    k-mers (SURVEY.md §5.7); a simulator with uniform random indels would
    make hpc seeding unrealistically hard.  Within a run the extend/shrink
    choice is a fair coin: aggregated over reads the observed run length
    is mode-centred on the true length (as on real instruments) — a
    one-sided model makes the majority read vote systematically +1, which
    no consensus algorithm can undo.
    """
    if err <= 0:
        return seq.copy()
    n = len(seq)
    p_sub = err * sub_frac
    p_ins = err * ins_frac
    p_del = err * del_frac
    r = rng.random(n)
    hp = rng.random(n) < hp_bias
    coin = rng.random(n) < 0.5  # fair extend/shrink choice inside runs
    ins_bases = rng.integers(0, 4, size=n, dtype=np.int64)
    sub_shift = rng.integers(1, 4, size=n, dtype=np.int64)
    out = []
    prev = -1
    for j in range(n):
        c = int(seq[j])
        x = r[j]
        indel = x < p_del + p_ins
        if indel and hp[j]:
            # homopolymer length noise, symmetric extend/shrink
            if coin[j]:
                out.append(c)
                out.append(c)
                prev = c
            else:
                if c == prev:
                    continue
                out.append(c)
                prev = c
        elif x < p_del:
            continue
        elif indel:
            out.append(int(ins_bases[j]))
            out.append(c)
            prev = c
        elif x < p_del + p_ins + p_sub:
            c = (c + int(sub_shift[j])) % 4
            out.append(c)
            prev = c
        else:
            out.append(c)
            prev = c
    return np.array(out, dtype=np.uint8)


def simulate_reads(
    genome: np.ndarray,
    coverage: float,
    mean_len: int,
    err: float,
    seed: int = 1,
    circular: bool = False,
    min_len: int = 1000,
) -> tuple[list[str], list[np.ndarray]]:
    """Sample noisy reads to the given coverage.  Returns (names, code arrays)."""
    rng = np.random.default_rng(seed)
    glen = len(genome)
    total_needed = int(coverage * glen)
    names: list[str] = []
    seqs: list[np.ndarray] = []
    total = 0
    i = 0
    g2 = np.concatenate([genome, genome]) if circular else genome
    while total < total_needed:
        ln = int(rng.gamma(4.0, mean_len / 4.0))
        ln = max(min_len, min(ln, glen if not circular else glen))
        if circular:
            start = int(rng.integers(0, glen))
        else:
            start = int(rng.integers(0, max(1, glen - ln + 1)))
        frag = g2[start : start + ln]
        if len(frag) < min_len:
            continue
        read = mutate_read(rng, frag, err)
        if rng.random() < 0.5:
            read = (3 - read[::-1]).astype(np.uint8)
        names.append(f"sim{i:08d}_{start}_{ln}")
        seqs.append(read)
        total += len(read)
        i += 1
    return names, seqs


def write_sim_fasta(path: str, names: list[str], seqs: list[np.ndarray]) -> None:
    from ..data.readbank import codes_to_seq
    from ..io.fasta import write_fasta

    with open(path, "w") as fh:
        for n, s in zip(names, seqs):
            write_fasta(fh, n, codes_to_seq(s))
