"""The benchmark's generator: seeds, the error model against a per-base
loop, its rates, the length model and the tiles' tiling paths."""

import numpy as np
import pytest

from portbench.gen import simulate as S
from portbench.gen.workload import genome_bank, tiling_path, unitig_tiles

SMALL = dict(genome_bp=60_000, circular=True, coverage=8, mean_len=3000,
             min_len=1000, err=0.13, sub_frac=0.15, ins_frac=0.55,
             del_frac=0.30, hp_bias=0.75, filter_min_len=1500, sizes_seed=7,
             unitig_bp=40_000)


def test_same_seed_same_bytes():
    big = 2**40 + 3
    g1, r1 = genome_bank(SMALL, big)
    g2, r2 = genome_bank(SMALL, big)
    assert np.array_equal(g1, g2) and np.array_equal(r1.bases, r2.bases)
    assert np.array_equal(r1.bounds, r2.bounds)
    _g3, r3 = genome_bank(SMALL, big + 1)
    assert not np.array_equal(r1.bases[:1000], r3.bases[:1000])
    t1 = unitig_tiles(SMALL, big, 2)
    t2 = unitig_tiles(SMALL, big, 2)
    for a, b in zip(t1, t2):
        assert a.offs == b.offs and a.backbone == b.backbone
        assert all(np.array_equal(x, y) for x, y in zip(a.reads, b.reads))


def test_template_lengths_same_for_every_seed():
    a = genome_bank(SMALL, 1)[1]
    b = genome_bank(SMALL, 2)[1]
    assert sorted(a.tlen.tolist()) == sorted(b.tlen.tolist())


class Recorder:
    """A generator that keeps every draw, in order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.draws = []

    def random(self, *a, **k):
        x = self.rng.random(*a, **k)
        self.draws.append(x)
        return x

    def integers(self, *a, **k):
        x = self.rng.integers(*a, **k)
        self.draws.append(x)
        return x


def loop_model(c, starts, draws, m):
    """The repo simulator's per-base loop (utils/simulate.py mutate_read),
    fed the block's draws: r for every base, then hp and coin for each
    indel, the inserted base of each plain insertion, the shift of each
    substitution."""
    r, hp_i, coin_i, insb_i, shift_i = draws
    p_del = np.float32(m.err * m.del_frac)
    p_ind = np.float32(m.err * (m.del_frac + m.ins_frac))
    p_all = np.float32(m.err * (m.del_frac + m.ins_frac + m.sub_frac))
    ind = np.flatnonzero(r < p_ind)
    hp = np.zeros(c.shape[0], bool)
    coin = np.zeros(c.shape[0], bool)
    hp[ind] = hp_i < m.hp_bias
    coin[ind] = coin_i < 0.5
    rest = ind[~hp[ind]]
    plain_ins = rest[r[rest] >= p_del]
    sub = np.flatnonzero((r >= p_ind) & (r < p_all))
    insb = np.zeros(c.shape[0], np.int64)
    insb[plain_ins] = insb_i
    shift = np.zeros(c.shape[0], np.int64)
    shift[sub] = shift_i
    reads = []
    for b0, b1 in zip(starts[:-1], starts[1:]):
        out = []
        prev = -1
        for j in range(b0, b1):
            cj = int(c[j])
            x = r[j]
            indel = x < p_ind
            if indel and hp[j]:
                if coin[j]:
                    out += [cj, cj]
                    prev = cj
                else:
                    if cj == prev:
                        continue
                    out.append(cj)
                    prev = cj
            elif x < p_del:
                continue
            elif indel:
                out += [int(insb[j]), cj]
                prev = cj
            elif x < p_all:
                cj = (cj + int(shift[j])) % 4
                out.append(cj)
                prev = cj
            else:
                out.append(cj)
                prev = cj
        reads.append(out)
    return reads


@pytest.mark.parametrize("err", [0.13, 0.15, 0.4])
def test_vectorised_model_is_the_loop(err):
    m = S.ErrorModel(err=err)
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 400, size=40)
    starts = np.concatenate([[0], np.cumsum(lens)])
    # homopolymer-rich templates stress the shrink rule
    c = np.repeat(rng.integers(0, 4, size=starts[-1]), 1)[: starts[-1]]
    c = np.where(rng.random(c.shape[0]) < 0.5, np.roll(c, 1), c)
    c = c.astype(np.uint8)
    rec = Recorder(9)
    out, olens, _twos, _zeros = S._mutate_block(rec, c, starts, m)
    want = loop_model(c, starts, rec.draws, m)
    assert olens.tolist() == [len(w) for w in want]
    assert out.tolist() == [b for w in want for b in w]


def _rate_model(**kw):
    base = dict(err=0.1, sub_frac=0.0, ins_frac=0.0, del_frac=0.0,
                hp_bias=0.0)
    base.update(kw)
    return S.ErrorModel(**base)


def test_error_class_rates():
    n = 400_000
    rng = np.random.default_rng(11)
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    starts = np.array([0, n])

    def run(m):
        return S.mutate_flat(np.random.default_rng(12), c, starts, m)[0]

    sd = lambda p: np.sqrt(p * (1 - p) / n)  # noqa: E731
    out = run(_rate_model(sub_frac=1.0))
    assert out.shape[0] == n
    assert abs((out != c).mean() - 0.1) < 5 * sd(0.1)
    out = run(_rate_model(del_frac=1.0))
    assert abs(1 - out.shape[0] / n - 0.1) < 5 * sd(0.1)
    out = run(_rate_model(ins_frac=1.0))
    assert abs(out.shape[0] / n - 1 - 0.1) < 5 * sd(0.1)
    # the whole model: extends add a base, shrinks drop one where the base
    # before is the same (1 in 4 on a random template)
    m = S.ErrorModel(err=0.13)
    p_ind = m.err * (m.del_frac + m.ins_frac)
    p_del = m.err * m.del_frac
    gain = (p_ind * m.hp_bias * 0.5 - p_ind * m.hp_bias * 0.5 * 0.25
            - p_del * (1 - m.hp_bias) + (p_ind - p_del) * (1 - m.hp_bias))
    out = run(m)
    assert abs(out.shape[0] / n - 1 - gain) < 5 * sd(0.13)


def test_mean_template_length():
    ln = S.template_lengths(3, 20_000_000, 9500, 1000, 10**9)
    assert ln.min() >= 1000
    sigma = 0.5 * 9500 / np.sqrt(ln.shape[0])
    assert abs(ln.mean() - 9500) < 4 * sigma
    assert 20_000_000 <= ln.sum() < 20_000_000 + ln.max()


def test_tiling_path_no_gap_and_tiles_covered():
    for t in unitig_tiles(SMALL, 2**33 + 1, 3):
        y = np.array(t.backbone)
        ys, ye = t.tstart[y], t.tend[y]
        order = np.argsort(ys)
        ys, ye = ys[order], ye[order]
        assert ys[0] == 0
        reach = np.maximum.accumulate(ye)
        assert np.all(ys[1:] < reach[:-1])          # each Y read overlaps
        assert reach[-1] == t.tend.max()            # the path reaches the end
        assert t.offs == sorted(t.offs)
        assert all(r.dtype == np.uint8 for r in t.reads)


def test_tiling_path_bridges_a_short_overlap():
    # no read overlaps the first by 1,000: the farthest that overlaps at
    # all extends the path
    start = np.array([0, 500, 900])
    end = np.array([1000, 3000, 5000])
    assert tiling_path(start, end).tolist() == [True, False, True]
    # a gap ends the path
    assert tiling_path(np.array([0, 2000]),
                       np.array([1000, 3000])).tolist() == [True, False]
