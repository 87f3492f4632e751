"""The benchmark's read simulator: a vectorised NumPy copy of the repo's
genome, length and error model (a random genome; read lengths
gamma(4, mean / 4) with a floor; a PacBio-like, indel-heavy and
homopolymer-biased error profile), with no loop over bases.

Every draw comes from the run's seed, except the read-length multiset,
which comes from the configuration's `sizes_seed`: every seed gets the
same template lengths, in another order, so the work of a unit does not
move with the seed.

The error model, base by base (c the template base, prev the last base
written):
- an indel (r < del + ins) that falls in the homopolymer share extends
  (write c twice) or shrinks (write c once, or nothing when prev == c)
  on a fair coin;
- another indel below `del` drops c; the rest of the indels write a
  random base, then c;
- a substitution writes c + 1..3 mod 4; everything else writes c.
`prev` after a base is c, except after a substitution (the new base) and
after a plain deletion (unchanged); so the shrink test needs only the
last base before it that was not a plain deletion, which a running
maximum finds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# bases per vectorised block of the error model (keeps the draws ~0.3 GB)
BLOCK_BASES = 1 << 23


@dataclasses.dataclass(frozen=True)
class ErrorModel:
    err: float
    sub_frac: float = 0.15
    ins_frac: float = 0.55
    del_frac: float = 0.30
    hp_bias: float = 0.75

    @classmethod
    def of(cls, cfg: dict) -> "ErrorModel":
        return cls(err=cfg["err"], sub_frac=cfg["sub_frac"],
                   ins_frac=cfg["ins_frac"], del_frac=cfg["del_frac"],
                   hp_bias=cfg["hp_bias"])


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole seed, however
    large, with small integer tags that keep the streams apart."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def template_lengths(sizes_seed: int, total: int, mean_len: int,
                     min_len: int, max_len: int) -> np.ndarray:
    """Lengths gamma(4, mean / 4), floored at min_len and capped at
    max_len, drawn until they sum to `total` bases."""
    rng = np.random.default_rng(sizes_seed)
    out = []
    got = 0
    while got < total:
        ln = rng.gamma(4.0, mean_len / 4.0, size=4096).astype(np.int64)
        ln = np.clip(ln, min_len, max_len)
        cut = np.searchsorted(np.cumsum(ln), total - got) + 1
        out.append(ln[:cut])
        got += int(ln[:cut].sum())
    return np.concatenate(out)


def mutate_flat(rng: np.random.Generator, seq: np.ndarray,
                starts: np.ndarray, model: ErrorModel):
    """Apply the error model to reads laid end to end.

    seq: uint8 [n] template bases; starts: int64 [m + 1] read bounds in
    seq.  Returns (bases uint8, bounds int64 [m + 1], twos, zeros): the
    reads as read, and the sorted template positions written twice and
    not at all, which map template positions to read positions
    (`Reads.read_coord`).  Blocks of whole reads keep the draws small;
    past the one uniform draw a base, only the positions with an error
    draw more."""
    parts = []
    bounds = [np.zeros(1, np.int64)]
    twos_all, zeros_all = [], []
    r0 = 0
    m = starts.shape[0] - 1
    while r0 < m:
        r1 = int(np.searchsorted(starts, starts[r0] + BLOCK_BASES,
                                 side="right")) - 1
        r1 = min(m, max(r1, r0 + 1))
        b0, b1 = int(starts[r0]), int(starts[r1])
        out, lens, twos, zeros = _mutate_block(
            rng, seq[b0:b1], starts[r0: r1 + 1] - b0, model)
        parts.append(out)
        twos_all.append(twos + b0)
        zeros_all.append(zeros + b0)
        bounds.append(bounds[-1][-1] + np.cumsum(lens))
        r0 = r1
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return (cat(parts, np.uint8), np.concatenate(bounds),
            cat(twos_all, np.int64), cat(zeros_all, np.int64))


def _mutate_block(rng, c, starts, m: ErrorModel):
    """One block of whole reads: c the template bases, starts its read
    bounds.  Returns (the reads' bases, each read's length, the positions
    written twice, the positions not written)."""
    k = c.shape[0]
    r = rng.random(k, dtype=np.float32)
    p_del = np.float32(m.err * m.del_frac)
    p_ind = np.float32(m.err * (m.del_frac + m.ins_frac))
    p_all = np.float32(m.err * (m.del_frac + m.ins_frac + m.sub_frac))
    ind = np.flatnonzero(r < p_ind)
    hp = rng.random(ind.shape[0], dtype=np.float32) < m.hp_bias
    coin = rng.random(ind.shape[0], dtype=np.float32) < 0.5
    extend = ind[hp & coin]
    shrink = ind[hp & ~coin]
    rest = ind[~hp]
    plain_del = rest[r[rest] < p_del]
    plain_ins = rest[r[rest] >= p_del]
    sub = np.flatnonzero((r >= p_ind) & (r < p_all))
    insb = rng.integers(0, 4, size=plain_ins.shape[0], dtype=np.uint8)
    shift = rng.integers(1, 4, size=sub.shape[0], dtype=np.uint8)
    written = c.copy()                 # the base written last at j
    written[sub] = (c[sub] + shift) & 3
    # prev at a shrink: `written` at the last position before it, in its
    # read, that was not a plain deletion
    is_del = np.zeros(k + 1, bool)
    is_del[plain_del] = True
    read_start = starts[np.searchsorted(starts, shrink, side="right") - 1]
    p = shrink - 1
    back = is_del[p] & (p >= read_start)
    while back.any():
        p[back] -= 1
        back &= is_del[p] & (p >= read_start)
    live = p >= read_start
    skip = shrink[live & (written[np.maximum(p, 0)] == c[shrink])]
    cnt = np.ones(k, np.int8)
    cnt[extend] = 2
    cnt[plain_ins] = 2
    cnt[plain_del] = 0
    cnt[skip] = 0
    out = np.repeat(written, cnt)
    # an insertion writes its random base before c: find its first slot
    twos = np.union1d(extend, plain_ins)
    zeros = np.union1d(plain_del, skip)
    at = (plain_ins + np.searchsorted(twos, plain_ins)
          - np.searchsorted(zeros, plain_ins))
    out[at] = insb
    lens = (np.diff(starts) + np.diff(np.searchsorted(twos, starts))
            - np.diff(np.searchsorted(zeros, starts)))
    return out, lens, twos, zeros


@dataclasses.dataclass
class Reads:
    """Reads as sequenced, with their truth."""

    bases: np.ndarray     # uint8 codes, reads end to end
    bounds: np.ndarray    # int64 [m + 1]
    start: np.ndarray     # int64 [m] template start in the genome
    tlen: np.ndarray      # int64 [m] template length
    reverse: np.ndarray   # bool [m] read from the reverse strand
    tflat: np.ndarray     # int64 [m] template start among all templates
    twos: np.ndarray      # sorted template positions written twice
    zeros: np.ndarray     # and not at all

    def __len__(self):
        return self.start.shape[0]

    def lengths(self) -> np.ndarray:
        return np.diff(self.bounds)

    def read(self, i: int) -> np.ndarray:
        return self.bases[self.bounds[i]: self.bounds[i + 1]]

    def subset(self, keep: np.ndarray) -> "Reads":
        idx = np.flatnonzero(keep)
        lens = self.lengths()[idx]
        bounds = np.zeros(idx.shape[0] + 1, np.int64)
        np.cumsum(lens, out=bounds[1:])
        bases = np.concatenate([self.read(int(i)) for i in idx]) \
            if idx.shape[0] else np.zeros(0, np.uint8)
        return Reads(bases, bounds, self.start[idx], self.tlen[idx],
                     self.reverse[idx], self.tflat[idx], self.twos,
                     self.zeros)

    def read_coord(self, i: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Where template offset t of forward read i lies in the read."""
        def out_pos(p):
            return (p + np.searchsorted(self.twos, p)
                    - np.searchsorted(self.zeros, p))
        base = self.tflat[i]
        return out_pos(base + t) - out_pos(base)


def sample_reads(rng: np.random.Generator, genome: np.ndarray,
                 lengths: np.ndarray, model: ErrorModel, *,
                 circular: bool, strands: bool) -> Reads:
    """Reads of the given template lengths, in a random order, at uniform
    starts (anywhere on a circular genome; so that they fit on a linear
    one), mutated, and reverse-complemented half of the time when
    `strands`."""
    glen = genome.shape[0]
    lens = rng.permutation(lengths).astype(np.int64)
    lens = np.minimum(lens, glen)
    if circular:
        start = rng.integers(0, glen, size=lens.shape[0], dtype=np.int64)
    else:
        start = (rng.random(lens.shape[0]) * (glen - lens + 1)).astype(np.int64)
    tb = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=tb[1:])
    g2 = np.concatenate([genome, genome]) if circular else genome
    templ = np.concatenate([g2[s: s + n] for s, n in zip(start.tolist(),
                                                         lens.tolist())])
    bases, bounds, twos, zeros = mutate_flat(rng, templ, tb, model)
    reverse = (rng.random(lens.shape[0]) < 0.5) if strands \
        else np.zeros(lens.shape[0], bool)
    if reverse.any():
        bases = _revcomp_reads(bases, bounds, reverse)
    return Reads(bases, bounds, start, lens, reverse, tb[:-1], twos, zeros)


def _revcomp_reads(bases, bounds, which):
    """A copy with the reads `which` reverse-complemented."""
    b = bounds.tolist()
    return np.concatenate([
        3 - bases[b[i]: b[i + 1]][::-1] if w else bases[b[i]: b[i + 1]]
        for i, w in enumerate(which.tolist())])
