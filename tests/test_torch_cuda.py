"""The port's CUDA kernels, overlapper and consensus on the card, held
against their plain PyTorch versions on the CPU (which the other
test_torch_* files hold against the JAX package).  Every test needs an NVIDIA GPU and skips
without one.  This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from smartdenovo_tpu_torch.kernels import _build
from smartdenovo_tpu_torch.ops import jpost, pexpand, segdp, sseg

I32_MAX = (1 << 31) - 1
DEFAULT_OPS = sseg.DEFAULT_OPS
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sseg_stream(rng, N):
    """Segments of 1 to ~100 entries, one longer than a block of 1024, and
    a dead tail (neutral lanes) over the last quarter."""
    seg_new = (rng.random(N) < 0.03).astype(np.int32)
    seg_new[0] = 1
    seg_new[N // 3: N // 3 + 3000] = 0
    v8 = rng.integers(-1000, 1 << 20, (8, N)).astype(np.int32)
    tail = N * 3 // 4
    seg_new[tail:] = 0
    v8[0, tail:] = 0
    v8[1:3, tail:] = I32_MAX
    v8[3:5, tail:] = 0
    v8[5:8, tail:] = I32_MAX
    return seg_new, v8


@pytest.mark.parametrize("ops", sseg.MAIN_PATH_OPS)
@pytest.mark.parametrize("N", [1000, 1024, 300_001])
def test_sseg_cuda_matches_plain(cuda, ops, N):
    seg_new, v8 = _sseg_stream(np.random.default_rng(N), N)
    n_seg = int(seg_new.sum())
    for ob in (n_seg + 5, n_seg // 2):
        got, gcnt = sseg.seg_reduce_compact(_t(seg_new).to(cuda),
                                            _t(v8).to(cuda), ops=ops,
                                            out_budget=ob)
        exp, ecnt = sseg.seg_reduce_compact(_t(seg_new), _t(v8), ops=ops,
                                            out_budget=ob)
        assert int(gcnt) == int(ecnt) == n_seg
        n = min(n_seg, ob)
        assert torch.equal(got[:, :n].cpu(), exp[:, :n])


def _sseg_check(seg_new, v8, ops, ob, dev, plain_dev="cpu"):
    """K1 on the card against its plain version (on plain_dev)."""
    got, gcnt = sseg.seg_reduce_compact(seg_new.to(dev), v8.to(dev), ops=ops,
                                        out_budget=ob)
    exp, ecnt = sseg.seg_reduce_compact_plain(
        seg_new.to(plain_dev), v8.to(plain_dev), ops=ops, out_budget=ob)
    assert int(gcnt) == int(ecnt)
    n = min(int(ecnt), ob)
    assert torch.equal(got[:, :n].cpu(), exp[:, :n].cpu())
    return int(ecnt)


def test_sseg_cuda_segment_over_10000_tiles(cuda):
    """One segment over ~16,000 tiles of 2048 entries, short ones around
    it; the plain version runs on the card too (2^25 entries)."""
    N = 1 << 25
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    seg_new = (torch.rand(N, generator=g, device=cuda) < 0.05).to(torch.int32)
    seg_new[5000:N - 5000] = 0
    v8 = torch.randint(-1000, 1 << 20, (8, N), generator=g, device=cuda,
                       dtype=torch.int32)
    n = _sseg_check(seg_new, v8, sseg.BLOCK_OPS, 1 << 12, cuda, plain_dev=cuda)
    assert (N - 10000) // _build.lib().sseg_tile() > 10_000 and n > 100


def test_sseg_main_path_ops_specialized(cuda):
    """Every lane-op set of the main path runs an instantiation compiled
    with its ops known; another set runs the generic one."""
    lib = _build.lib()
    for ops in sseg.MAIN_PATH_OPS:
        assert lib.sseg_specialized(sseg.opcode(ops)) == 1, ops
    assert lib.sseg_specialized(sseg.opcode(("min",) * 8)) == 0


@pytest.mark.parametrize("N", [1, 5, 2047, 2049, 4096 * 3 + 3, 100_001])
def test_sseg_cuda_ragged_lengths(cuda, N):
    """N not a multiple of the tile (2048) or of the vector width (4)."""
    seg_new, v8 = _sseg_stream(np.random.default_rng(N), N)
    for ob in (N + 1, max(1, int(seg_new.sum()) // 2)):
        _sseg_check(_t(seg_new), _t(v8), DEFAULT_OPS, ob, cuda)


@pytest.mark.parametrize("kind", ["every", "single", "misaligned"])
def test_sseg_cuda_flag_patterns(cuda, kind):
    """A start at every entry, a single segment, and a stream whose
    pointers are not 16-byte aligned (the scalar load path)."""
    N = 70_000
    rng = np.random.default_rng(7)
    seg_new, v8 = _sseg_stream(rng, N)
    if kind == "every":
        seg_new[:] = 1
    elif kind == "single":
        seg_new[:] = 0
    f, v = _t(seg_new), _t(v8)
    if kind == "misaligned":
        f = torch.cat([torch.zeros(1, dtype=torch.int32), f]).to(cuda)[1:]
        buf = torch.zeros(8 * N + 1, dtype=torch.int32, device=cuda)
        buf[1:] = v.flatten().to(cuda)
        v = buf[1:].view(8, N)
    n = _sseg_check(f, v, DEFAULT_OPS, N, cuda)
    assert n == {"every": N, "single": 1}.get(kind, int(seg_new[1:].sum()) + 1)


@pytest.mark.parametrize("op", ["sum", "min", "max", "first"])
def test_sseg_cuda_each_op_each_lane(cuda, op):
    """Every lane under one op; values span the int32 range (sums wrap)
    and hold INT32_MAX often, so "first" skips some."""
    N = 50_000
    rng = np.random.default_rng(["sum", "min", "max", "first"].index(op))
    seg_new = (rng.random(N) < 0.02).astype(np.int32)
    v8 = rng.integers(-(1 << 31), I32_MAX, (8, N), dtype=np.int64)
    v8[rng.random((8, N)) < 0.3] = I32_MAX
    v8 = v8.astype(np.int32)
    n = int(seg_new[1:].sum()) + 1
    for ob in (n, n - 3):
        _sseg_check(_t(seg_new), _t(v8), (op,) * 8, ob, cuda)


def _join_stream(rng, N):
    """Sorted join keys: runs of query entries (side 0) then candidate
    entries (side 1), some runs at or over max_per_read, dead tail."""
    keys = []
    g = 0
    while len(keys) < N * 4 // 5:
        g += int(rng.integers(1, 50))
        keys += [g << 1] * int(rng.integers(0, 20))
        keys += [(g << 1) | 1] * int(rng.integers(0, 6))
    key = np.full(N, I32_MAX, np.int32)
    key[:N * 4 // 5] = keys[:N * 4 // 5]
    pay = rng.integers(-(1 << 31), I32_MAX, N).astype(np.int32)
    aux = rng.integers(0, 1 << 20, N).astype(np.int32)
    return key, pay, aux


@pytest.mark.parametrize("N", [1024, 5000, 400_000])
def test_jpost_cuda_matches_plain(cuda, N):
    key, pay, aux = _join_stream(np.random.default_rng(N), N)
    for ob in (N, 17):
        assert _jpost_check(_t(key), _t(pay), _t(aux), 16, ob, cuda) > 0


def _jpost_check(key, pay, aux, mpr, ob, dev, plain_dev="cpu"):
    """K2 on the card against its plain version (on plain_dev); returns
    the emitter count."""
    got, gnem, gtot = jpost.join_emitters(key.to(dev), pay.to(dev),
                                          aux.to(dev), max_per_read=mpr,
                                          out_budget=ob)
    exp, enem, etot = jpost.join_emitters_plain(
        key.to(plain_dev), pay.to(plain_dev), aux.to(plain_dev),
        max_per_read=mpr, out_budget=ob)
    assert got.shape == exp.shape == (4, ob)
    assert (int(gnem), int(gtot)) == (int(enem), int(etot))
    n = min(int(enem), ob)
    assert torch.equal(got[:, :n].cpu(), exp[:, :n].cpu())
    return int(enem)


def test_jpost_cuda_open_run_over_10000_tiles(cuda):
    """One query entry, then 2^25 - 1 candidate entries of its run: every
    one emits with qcnt 1, so the open run's count crosses ~16,000 tiles;
    the plain version runs on the card too."""
    N = 1 << 25
    key = torch.full((N,), (5 << 1) | 1, dtype=torch.int32, device=cuda)
    key[0] = 5 << 1
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    pay, aux = (torch.randint(-(1 << 31), I32_MAX, (N,), generator=g,
                              device=cuda, dtype=torch.int32)
                for _ in range(2))
    n = _jpost_check(key, pay, aux, 16, N, cuda, plain_dev=cuda)
    assert n == N - 1 and N // _build.lib().jpost_tile() > 10_000


@pytest.mark.parametrize("mpr", [16, 4096])
def test_jpost_cuda_query_run_over_a_tile(cuda, mpr):
    """A run of 3000 query entries (more than a tile of 2048), then its
    500 candidates: they emit qcnt 3000 under max_per_read 4096 and
    nothing under 16; short runs after them emit in both."""
    rng = np.random.default_rng(mpr)
    key, pay, aux = _join_stream(rng, 20_000)
    rest = key[:20_000 - 3500]
    key[3500:] = np.where(rest != I32_MAX, rest + (2 << 1), rest)
    key[:3000] = 1 << 1
    key[3000:3500] = (1 << 1) | 1
    key[-2000:] = I32_MAX
    n = _jpost_check(_t(key), _t(pay), _t(aux), mpr, 20_000, cuda)
    assert n > (500 if mpr == 4096 else 0)


@pytest.mark.parametrize("kind", ["queries", "candidates", "dead"])
def test_jpost_cuda_no_emitter(cuda, kind):
    """Streams with no emitter: query entries only, candidate entries
    without a query entry in their run, all INT32_MAX."""
    N = 10_000
    rng = np.random.default_rng(3)
    grp = np.sort(rng.integers(0, 500, N)).astype(np.int32) << 1
    key = {"queries": grp, "candidates": grp | 1,
           "dead": np.full(N, I32_MAX, np.int32)}[kind]
    pay, aux = (_t(rng.integers(0, 1 << 20, N).astype(np.int32))
                for _ in range(2))
    assert _jpost_check(_t(key), pay, aux, 16, 64, cuda) == 0


@pytest.mark.parametrize("N", [1, 7, 2047, 2049, 2048 * 3 + 5, 100_001])
def test_jpost_cuda_ragged_lengths(cuda, N):
    """N not a multiple of the tile (2048) or of the vector width (4),
    with an out_budget above and one below the emitter count."""
    key, pay, aux = _join_stream(np.random.default_rng(N), N)
    args = (_t(key), _t(pay), _t(aux))
    n = _jpost_check(*args, 16, N, cuda)
    for ob in (max(1, n // 3), 1):
        _jpost_check(*args, 16, ob, cuda)


def test_jpost_cuda_misaligned(cuda):
    """key, pay and aux 4 bytes past a 16-byte boundary (the scalar key
    loads), with an out_budget below the emitter count."""
    N = 70_001
    key, pay, aux = _join_stream(np.random.default_rng(8), N)
    off = [torch.cat([torch.zeros(1, dtype=torch.int32), _t(a)]).to(cuda)[1:]
           for a in (key, pay, aux)]
    assert all(a.data_ptr() % 16 == 4 for a in off)
    n = _jpost_check(*off, 16, N, cuda)
    _jpost_check(*off, 16, n - 100, cuda)


@pytest.mark.parametrize("kernel", ["jpost", "pexpand"])
def test_lookback_kernels_repeat(cuda, kernel):
    """K2 and K3 at the main path's width (2^23), 20 launches in a row, each
    equal to the plain version: the tiles' look-back words race with their
    readers, and a torn or stale word would show as a wrong record."""
    N = 1 << 23
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    grp = torch.sort(torch.randint(0, N // 8, (N,), generator=g, device=cuda,
                                   dtype=torch.int32)).values
    side = torch.randint(0, 2, (N,), generator=g, device=cuda,
                         dtype=torch.int32)
    key = torch.sort((grp << 1) | side).values
    pay, aux = (torch.randint(-(1 << 31), I32_MAX, (N,), generator=g,
                              device=cuda, dtype=torch.int32)
                for _ in range(2))
    exp = jpost.join_emitters_plain(key, pay, aux, max_per_read=16,
                                    out_budget=N)
    n = int(exp[1])
    cnt = torch.where(torch.arange(N, device=cuda) < n, exp[0][0], 0)
    pexp = pexpand.expand_emit_plain(cnt, exp[0][1], exp[0][2], exp[0][3],
                                     pair_budget=N)
    assert n > N // 10
    for _ in range(20):
        if kernel == "jpost":
            got = jpost.join_emitters(key, pay, aux, max_per_read=16,
                                      out_budget=N)
            assert (int(got[1]), int(got[2])) == (n, int(exp[2]))
            assert torch.equal(got[0][:, :n], exp[0][:, :n])
        else:
            got = pexpand.expand_emit(cnt, exp[0][1], exp[0][2], exp[0][3],
                                      pair_budget=N)
            assert all(torch.equal(a, b) for a, b in zip(got, pexp))


def _pexpand_check(cnt, pb, dev):
    """K3 on the card against its plain version on the CPU, with seeded
    payloads."""
    rng = np.random.default_rng(len(cnt))
    args = [cnt] + [rng.integers(-(1 << 31), I32_MAX, len(cnt))
                    .astype(np.int32) for _ in range(3)]
    got = pexpand.expand_emit(*(_t(a).to(dev) for a in args), pair_budget=pb)
    exp = pexpand.expand_emit(*(_t(a) for a in args), pair_budget=pb)
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


@pytest.mark.parametrize("NE", [1, 5000, 300_000])
def test_pexpand_cuda_matches_plain(cuda, NE):
    rng = np.random.default_rng(NE)
    cnt = rng.integers(0, 15, NE).astype(np.int32)
    cnt[NE // 2 + 1:] = 0
    for pb in (int(cnt.sum()) + 100, int(cnt.sum()) // 2 + 1):
        _pexpand_check(cnt, pb, cuda)


def test_pexpand_cuda_zero_runs(cuda):
    """Zero counts between nonzero ones: single zeros, and runs of 5,000
    and 20,000 zeros (longer than a block's 2048 merge-path items)."""
    rng = np.random.default_rng(21)
    cnt = rng.integers(0, 9, 60_000).astype(np.int32)
    cnt[rng.random(60_000) < 0.3] = 0
    cnt[10_000:15_000] = 0
    cnt[30_000:50_000] = 0
    total = int(cnt.sum())
    for pb in (total + 4099, total - 7, 4097):
        _pexpand_check(cnt, pb, cuda)


def test_pexpand_cuda_emitter_over_100000_slots(cuda):
    """One emitter owns 150,000 slots among short ones; the budget ends
    past the total, inside the long run, and just after it."""
    rng = np.random.default_rng(22)
    cnt = rng.integers(0, 6, 3000).astype(np.int32)
    cnt[1500] = 150_000
    start = int(cnt[:1500].sum())
    for pb in (int(cnt.sum()) + 1000, start + 77_777, start + 150_001):
        _pexpand_check(cnt, pb, cuda)


def test_pexpand_cuda_budget_cuts_runs(cuda):
    """Budgets that end inside an emitter's run, at every offset mod 4
    (the 16-byte stores' edge)."""
    rng = np.random.default_rng(23)
    cnt = rng.integers(1, 40, 20_000).astype(np.int32)
    cum = np.cumsum(cnt)
    for k in (7, 5000, 19_998):
        for d in range(1, 5):
            _pexpand_check(cnt, int(cum[k]) - d, cuda)


@pytest.mark.parametrize("case", ["one", "all_zero"])
def test_pexpand_cuda_degenerate(cuda, case):
    """NE = 1 (budgets below, at and above its count), and all counts 0
    (every slot is 0)."""
    if case == "one":
        for pb in (3, 9, 100):
            _pexpand_check(np.array([9], np.int32), pb, cuda)
    else:
        for ne, pb in ((1, 1), (5000, 1000), (3, 70_001)):
            _pexpand_check(np.zeros(ne, np.int32), pb, cuda)


@pytest.mark.parametrize("matcher", ["auto", "join"])
def test_overlap_dmo_cuda_matches_cpu(cuda, matcher):
    """The whole overlapper, record for record; the join run must have
    gone through all three kernels."""
    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    rng = np.random.default_rng(11)
    genome = random_genome(rng, 30_000)
    names, seqs = simulate_reads(genome, coverage=10, mean_len=5000,
                                 err=0.13, seed=12)
    rb = ReadBank(names, seqs)
    p = ZmoParams.dmo(batch_q=8, ncand=64, matcher=matcher)
    _build.reset_launches()
    got = overlap_dmo(rb, p, progress=False, device="cuda")
    launches = dict(_build.LAUNCHES)
    exp = overlap_dmo(rb, p, progress=False, device="cpu")
    assert got == exp and len(got) > 50
    assert launches["sseg"] > 0
    if matcher == "join":
        assert launches["jpost"] > 0 and launches["pexpand"] > 0


# ------------------------------------------------ consensus (segment engine)
# The input makers below are JAX-free; tests/test_torch_segdp.py and
# tests/test_torch_cns.py feed the same inputs to the JAX package.


def segments(rng, Bc, SEGR, LBW, W):
    """Read segments mutated (13% substitutions) from a random consensus,
    with band bases jittered so that they step up and down, alen from 0 to
    SEGR and windows shorter than LBW."""
    NB = SEGR // 16 + 2
    cns = rng.integers(0, 4, LBW + SEGR, dtype=np.uint8)
    a = np.full((Bc, SEGR), 4, np.uint8)
    b = np.full((Bc, LBW), 4, np.uint8)
    alen = np.zeros(Bc, np.int32)
    blen = np.zeros(Bc, np.int32)
    b16 = np.zeros((Bc, NB), np.int16)
    for k in range(Bc):
        off = int(rng.integers(0, LBW - SEGR + 1))
        ln = (SEGR, 0, int(rng.integers(1, SEGR + 1)))[k % 3]
        src = cns[off: off + ln].copy()
        err = rng.random(ln) < 0.13
        src[err] = rng.integers(0, 4, int(err.sum()))
        a[k, :ln] = src
        alen[k] = ln
        blen[k] = int(rng.integers(LBW * 3 // 4, LBW + 1))
        b[k, :blen[k]] = cns[:blen[k]]
        c = off + np.arange(NB) * 16 - W // 2 + rng.integers(-24, 25, NB)
        b16[k] = np.clip(c, 0, LBW - 1)
    return a, b, alen, blen, b16


def probe_tie_inputs(rng, B=6, L=1500, period=50):
    """Probe-anchoring inputs whose hits tie: every window repeats a random
    unit of `period` bases, and doff sits half a period off the true
    diagonal, so the two nearest hits are equally far from it."""
    a = np.full((B, 2048), 4, np.uint8)
    w = np.full((B, 2048), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    wlen = np.zeros(B, np.int32)
    doff = np.zeros(B, np.int32)
    for k in range(B):
        unit = rng.integers(0, 4, period, dtype=np.uint8)
        win = np.tile(unit, L // period + 4)[: L + 200]
        s0 = int(rng.integers(0, period))
        read = win[s0: s0 + L - 100 * (k % 2)]
        a[k, :len(read)] = read
        alen[k] = len(read)
        w[k, :len(win)] = win
        wlen[k] = len(win)
        doff[k] = s0 + period // 2
    return a, alen, w, wlen, doff


def unit_12kb(LayUnitig=None):
    """The 12 kb unit of tests/test_cns.py: 28 backbone reads of 3.5 kb at
    13% error every 400 bp, and 3 more that are not backbone."""
    from smartdenovo_tpu_torch.utils.simulate import mutate_read, random_genome

    if LayUnitig is None:
        from smartdenovo_tpu_torch.pipeline.cns import LayUnitig
    rng = np.random.default_rng(55)
    truth = random_genome(rng, 12000)
    reads, offs, bb = [], [], []
    for start in list(range(0, 12000 - 1000, 400)) + [700, 4200, 8300]:
        reads.append(mutate_read(rng, truth[start: start + 3500], 0.13))
        offs.append(start)
        bb.append(len(reads) <= 28)
    return LayUnitig(name="utg0", reads=reads, offs=offs, backbone=bb)


@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
@pytest.mark.parametrize("shape", [(8, 128, 256, 64, 512),
                                   (96, 2048, 3072, 256, 3072)])
def test_segdp_cuda_matches_plain(cuda, shape, gaps):
    Bc, SEGR, LBW, W, T = shape
    args = segments(np.random.default_rng(Bc + gaps[0]), Bc, SEGR, LBW, W)
    kw = dict(SEGR=SEGR, LBW=LBW, W=W, T=T, open_i=gaps[0], open_d=gaps[1])
    n0 = _build.LAUNCHES["segdp"]
    got = segdp.seg_align_tb(*(_t(x).to(cuda) for x in args), **kw)
    assert _build.LAUNCHES["segdp"] == n0 + 1
    exp = segdp.seg_align_tb(*(_t(x) for x in args), **kw)
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


def edge_segments(rng, Bc, SEGR, LBW, W, step):
    """segments() with band bases that step by up to `step` columns every
    16 rows (several band lanes a row), and every fourth window shorter
    than the band."""
    a, b, alen, blen, b16 = segments(rng, Bc, SEGR, LBW, W)
    NB = b16.shape[1]
    walk = np.cumsum(rng.integers(0, step + 1, (Bc, NB)), axis=1)
    b16 = np.clip(walk - W // 2, 0, LBW - 1).astype(np.int16)
    short = np.arange(Bc) % 4 == 3
    blen[short] = rng.integers(1, W, int(short.sum()))
    b[short] = np.where(np.arange(LBW)[None, :] < blen[short, None],
                        b[short], 4)
    return a, b, alen, blen, b16


@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
@pytest.mark.parametrize("W", [32, 64, 128, 256])
def test_segdp_cuda_edge_bands(cuda, W, gaps):
    """Band steps of up to 200 columns a 16-row sample (more than one
    lane's 8 band lanes a row), alen 0 and SEGR, windows shorter than the
    band, both gap-open pairs, every band width the kernel takes."""
    SEGR, LBW, T = 512, 4096, 768
    args = edge_segments(np.random.default_rng(W - gaps[0]), 48, SEGR, LBW,
                         W, 200)
    assert (args[2] == 0).any() and (args[2] == SEGR).any()
    assert (args[3] < W).any()
    kw = dict(SEGR=SEGR, LBW=LBW, W=W, T=T, open_i=gaps[0], open_d=gaps[1])
    got = segdp.seg_align_tb(*(_t(x).to(cuda) for x in args), **kw)
    exp = segdp.seg_align_tb(*(_t(x) for x in args), **kw)
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


def test_segdp_cuda_one_wave(cuda):
    """A call of 1024 segments at the consensus stage's widths is one
    wave: every segment's warp is resident at once."""
    wpb, per_sm = segdp.launch_shape(2048, 3072, 256)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1024 <= wpb * per_sm * sms


def test_probe_anchor_ties_cuda_matches_cpu(cuda):
    from smartdenovo_tpu_torch.pipeline.cns import _probe_anchor_device

    args = [_t(x) for x in probe_tie_inputs(np.random.default_rng(5))]
    exp = _probe_anchor_device(*args)
    got = _probe_anchor_device(*(x.to(cuda) for x in args))
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


def test_consensus_unitig_cuda_matches_cpu(cuda):
    """The 12 kb unit of tests/test_cns.py, two iterations: codes and
    offsets bit-equal; the cuda run went through the segdp kernel."""
    from smartdenovo_tpu_torch.pipeline.cns import CnsParams, consensus_unitig

    unit = unit_12kb()
    p = CnsParams(n_iter=2)
    n0 = _build.LAUNCHES["segdp"]
    got = consensus_unitig(unit, p, return_offs=True, device="cuda")
    assert _build.LAUNCHES["segdp"] > n0
    exp = consensus_unitig(unit, p, return_offs=True, device="cpu")
    assert np.array_equal(got[0], exp[0]) and got[1] == exp[1]


# ---- the whole-read DPs: csrc/banded.cu and csrc/refine.cu -----------------
# The generators below are shared with tests/test_torch_banded_refine.py,
# which feeds the same inputs to the JAX package.


def _noisy(rng, src, err=0.12):
    """src with err of its bases substituted, inserted or deleted (a third
    each) and 2% of the result turned into N (code 4)."""
    out = []
    for c in src:
        r = rng.random()
        if r < err / 3:
            out.append((int(c) + 1 + int(rng.integers(3))) % 4)
        elif r < 2 * err / 3:
            out += [int(c), int(rng.integers(4))]
        elif r >= err:
            out.append(int(c))
    out = np.array(out, np.uint8)
    out[rng.random(out.size) < 0.02] = 4
    return out


def banded_inputs(rng, B, LA, W, jump=True):
    """B reads against consensus windows, as the consensus align pass
    gives them: read k is a noisy copy of its window from an offset of up
    to W, windows carry N codes too, the band comes from anchors every 100
    rows through make_band_centers (negative bases where the window starts
    near the read).  Read 1 has alen 0, read 2 a window of length 0; read 0
    fills LA; with `jump`, read 3's band steps by W + 37 columns at one row
    (the whole previous row out of band)."""
    from smartdenovo_tpu_torch.ops.banded import make_band_centers

    a = np.full((B, LA), 4, np.uint8)
    LB = LA + 3 * W
    b = np.full((B, LB), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    anchors = []
    for k in range(B):
        win = rng.integers(0, 4, LB, dtype=np.uint8)
        win[rng.random(LB) < 0.01] = 4
        off = int(rng.integers(0, W))
        read = _noisy(rng, win[off:off + LA])[:LA]
        n = LA if k == 0 else (0 if k == 1 else int(rng.integers(LA // 3, LA + 1)))
        n = min(n, read.size)
        a[k, :n] = read[:n]
        alen[k] = n
        blen[k] = 0 if k == 2 else min(LB, off + n + int(rng.integers(0, W)))
        b[k, :blen[k]] = win[:blen[k]]
        anchors.append([(x, off + x) for x in range(50, n, 100)])
    base = make_band_centers(anchors, alen, blen, LA, W)
    if jump and B > 3:
        base[3, LA // 3:] += W + 37
        np.maximum.accumulate(base[3], out=base[3])
    return a, b, alen, blen, base


def refine_inputs(rng, B, LA, W, indel=0):
    """B (read, window) pairs of a refine batch and their band: read k is
    a noisy copy of its window, the prior CIGAR one all-M run, so the band
    follows the diagonal.  With `indel`, read 0 also loses `indel` bases
    at its middle and its prior CIGAR says so (M, D indel, M), as a large
    deletion makes refine_alignment_batch pick a wide band tier.  Read 1
    has alen 0; windows carry N codes."""
    from smartdenovo_tpu_torch.ops.refine import band_from_cigar

    a = np.full((B, LA), 4, np.uint8)
    LB = LA + indel + W
    b = np.full((B, LB), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    cigars = []
    for k in range(B):
        n = LA if k == 0 else (0 if k == 1 else int(rng.integers(LA // 3, LA)))
        win = rng.integers(0, 4, LB, dtype=np.uint8)
        win[rng.random(LB) < 0.01] = 4
        read = _noisy(rng, win[: n + (indel if k == 0 else 0)])
        if k == 0 and indel:
            h = read.size // 2
            read = np.concatenate([read[:h], read[h + indel:]])
        read = read[:n]
        n = read.size
        bl = min(LB, n + (indel if k == 0 else 0) + int(rng.integers(0, 8)))
        a[k, :n] = read
        b[k, :bl] = win[:bl]
        alen[k], blen[k] = n, bl
        if k == 0 and indel:
            h = n // 2
            cigars.append((["M", "D", "M"], [h, indel, max(n - h, 1)]))
        else:
            cigars.append((["M"], [max(n, bl, 1)]))
    base = band_from_cigar(cigars, alen, blen, LA, W)
    return a, b, alen, blen, base, cigars


def tracks_for(rng, a):
    """The five 5q tracks [B, LA] i32 of a batch: SubQV, InsQV, DelQV in
    3..40, SubTag and DelTag codes 0..4 (4 = N, which the 5q costs compare
    raw)."""
    B, LA = a.shape
    q = [rng.integers(3, 41, (B, LA)).astype(np.int32) for _ in range(3)]
    return q + [rng.integers(0, 5, (B, LA)).astype(np.int32) for _ in range(2)]


def quals_for(rng, pairs):
    """[7, len(read)] u8 f5q tracks per pair, as parse_lay_file gives them:
    QVs in 3..40 on tracks 1-3, tag codes 0..4 on tracks 5-6."""
    out = []
    for a, _ in pairs:
        q = np.zeros((7, len(a)), np.uint8)
        q[1:4] = rng.integers(3, 41, (3, len(a)))
        q[5:7] = rng.integers(0, 5, (2, len(a)))
        out.append(q)
    return out


def assert_dp_equal(got, exp, alen, ndirs=2):
    """DP outputs equal: every output but dirs whole; dirs (at index
    ndirs) on the rows 0..alen of each read, the rows the kernel writes."""
    for n, (g, e) in enumerate(zip(got, exp)):
        g, e = g.cpu(), e.cpu()
        if n != ndirs:
            assert torch.equal(g, e), n
            continue
        for k, ln in enumerate(alen):
            assert torch.equal(g[k, :int(ln) + 1], e[k, :int(ln) + 1]), k


@pytest.mark.parametrize("semi", [True, False])
@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
@pytest.mark.parametrize("W", [32, 64, 96, 128, 256])
def test_banded_cuda_matches_plain(cuda, W, gaps, semi):
    """Every read a different alen (0 and LA among them), a window of
    length 0, N codes, negative bases and a band step past W."""
    from smartdenovo_tpu_torch.ops.banded import banded_align

    LA = 700
    args = banded_inputs(np.random.default_rng(W + gaps[0]), 12, LA, W)
    assert (args[4] < 0).any()
    kw = dict(LA=LA, W=W, gap_a=gaps[0], gap_b=gaps[1], semiglobal_b=semi)
    n0 = _build.LAUNCHES["banded"]
    got = banded_align(*(_t(x).to(cuda) for x in args), **kw)
    assert _build.LAUNCHES["banded"] == n0 + 1
    exp = banded_align(*(_t(x) for x in args), **kw)
    assert_dp_equal(got, exp, args[2])


@pytest.mark.parametrize("semi", [True, False])
@pytest.mark.parametrize("W", [32, 96, 256])
def test_banded_cuda_rowmax_matches_plain(cuda, W, semi):
    """The row maxima (rmax, rcol) with the other outputs: a read of alen
    0, reads shorter than the batch's longest (their rows past alen), a
    window of length 0 and rows whose every lane is masked (read 3's band
    stepped past its window)."""
    from smartdenovo_tpu_torch.ops.banded import NEG_INF, banded_align

    LA = 500
    args = banded_inputs(np.random.default_rng(W + 7), 10, LA, W)
    kw = dict(LA=LA, W=W, gap_a=-2, gap_b=-3, semiglobal_b=semi,
              return_rowmax=True)
    n0 = _build.LAUNCHES["banded"]
    got = banded_align(*(_t(x).to(cuda) for x in args), **kw)
    assert _build.LAUNCHES["banded"] == n0 + 1
    exp = banded_align(*(_t(x) for x in args), **kw)
    assert len(got) == 7
    alen = args[2]
    rmax = exp[5].numpy()
    masked = [(rmax[k, 1:alen[k] + 1] == NEG_INF).any() for k in range(10)]
    assert alen.min() == 0 and (alen < alen.max()).sum() > 1 and any(masked)
    assert_dp_equal(got, exp, alen)


def stepped_band(rng, LA, W, alen, start):
    """Bases of a read whose band steps mix 0, 1 and 2 on most rows with
    steps of 33 at a fifth and two fifths of it and one of W + 37 at
    three quarters (the whole previous row out of band), so the register
    shift and the shared buffer take turns; rows past alen keep
    base[alen]."""
    steps = np.array([1, 0, 1, 2, 1, 1, 0, 1])[np.arange(LA) % 8]
    steps[[alen // 5, 2 * alen // 5]] = 33
    steps[3 * alen // 4] = W + 37
    base = np.full(LA + 1, start, np.int64)
    base[1:alen + 1] += np.cumsum(steps[:alen])
    base[alen + 1:] = base[alen]
    return base.astype(np.int32)


def stepped_inputs(rng, LA, W, start):
    """Three reads on stepped bands: read 0 fills LA, read 1 has 2/3 of
    it and a window that ends inside its last rows' band, read 2 alen 0.
    A read follows its band's centre in a random window with 10% of its
    bases redrawn; 2% of both are N."""
    B = 3
    alen = np.array([LA, 2 * LA // 3, 0], np.int32)
    bases = [stepped_band(rng, LA, W, int(n), start) for n in alen]
    LB = int(max(b[-1] for b in bases)) + W + 8
    a = np.full((B, LA), 4, np.uint8)
    b = rng.integers(0, 4, (B, LB)).astype(np.uint8)
    blen = np.zeros(B, np.int32)
    for k in range(B):
        n = int(alen[k])
        col = np.clip(bases[k][1:n + 1] + W // 2 - 1, 0, LB - 1)
        read = b[k, col]
        sub = rng.random(n) < 0.1
        read[sub] = rng.integers(0, 4, int(sub.sum()))
        a[k, :n] = read
        blen[k] = LB - 4 if k != 1 else int(bases[k][n]) + W // 2
        b[k, blen[k]:] = 4
    a[rng.random(a.shape) < 0.02] = 4
    b[rng.random(b.shape) < 0.02] = 4
    return a, b, alen, blen, np.stack(bases)


@pytest.mark.parametrize("semi", [True, False])
@pytest.mark.parametrize("W", [32, 64, 96, 128, 160, 192, 224, 256])
def test_banded_cuda_band_steps(cuda, W, semi):
    """Band steps of 0, 1, 2, 33 and W + 37 in one read, at every width,
    from a band that starts left of the window, with the row maxima."""
    from smartdenovo_tpu_torch.ops.banded import banded_align

    LA = 400
    args = stepped_inputs(np.random.default_rng(W), LA, W, -(W // 3))
    steps = np.diff(args[4][0])
    assert {0, 1, 2, 33, W + 37} <= set(steps.tolist())
    kw = dict(LA=LA, W=W, gap_a=-2, gap_b=-3, semiglobal_b=semi,
              return_rowmax=True)
    got = banded_align(*(_t(x).to(cuda) for x in args), **kw)
    exp = banded_align(*(_t(x) for x in args), **kw)
    assert_dp_equal(got, exp, args[2])


@pytest.mark.parametrize("q5", [False, True])
@pytest.mark.parametrize("W", [64, 128, 256, 512, 1024])
def test_refine_cuda_band_steps(cuda, W, q5):
    """Band steps of 0, 1, 2, 33 and W + 37 in one read at every band
    tier (the wide ones keep the shared form), both cost models."""
    from smartdenovo_tpu_torch.ops.refine import refine_banded_affine
    from smartdenovo_tpu_torch.ops.refine5q import refine5q_banded

    LA = 400
    rng = np.random.default_rng(W + q5)
    a, b, alen, blen, base = stepped_inputs(rng, LA, W, 0)
    if q5:
        args = (a, b, *tracks_for(rng, a), alen, blen, base)
        fn, kw, name = refine5q_banded, dict(LA=LA, W=W), "refine5q"
    else:
        args = (a, b, alen, blen, base)
        fn, kw = refine_banded_affine, dict(LA=LA, W=W, open_i=-2, open_d=-3)
        name = "refine"
    n0 = _build.LAUNCHES[name]
    got = fn(*(_t(x).to(cuda) for x in args), **kw)
    assert _build.LAUNCHES[name] == n0 + 1
    exp = fn(*(_t(x) for x in args), **kw)
    assert_dp_equal(got, exp, alen, ndirs=1)


@pytest.mark.parametrize("kind", ["banded", "refine", "refine5q"])
def test_whole_read_cuda_many_reads(cuda, kind):
    """528 reads of up to 2048 rows in one call, several on each SM (the
    launch puts up to four reads in a block), equal to the plain version."""
    from smartdenovo_tpu_torch.ops.banded import banded_align
    from smartdenovo_tpu_torch.ops.refine import refine_banded_affine
    from smartdenovo_tpu_torch.ops.refine5q import refine5q_banded

    B, LA = 528, 2048
    rng = np.random.default_rng(528)
    if kind == "banded":
        W = 256
        args = banded_inputs(rng, B, LA, W)
        fn, kw = banded_align, dict(LA=LA, W=W, gap_a=-2, gap_b=-3,
                                    semiglobal_b=True)
    else:
        W = 128
        a, b, alen, blen, base, _ = refine_inputs(rng, B, LA, W)
        if kind == "refine":
            args = (a, b, alen, blen, base)
            fn, kw = refine_banded_affine, dict(LA=LA, W=W)
        else:
            args = (a, b, *tracks_for(rng, a), alen, blen, base)
            fn, kw = refine5q_banded, dict(LA=LA, W=W)
    alen = args[-3]
    got = fn(*(_t(x).to(cuda) for x in args), **kw)
    exp = fn(*(_t(x) for x in args), **kw)
    assert_dp_equal(got, exp, alen, ndirs=2 if kind == "banded" else 1)


@pytest.mark.parametrize("W,indel", [(64, 0), (128, 0), (256, 0),
                                     (512, 200), (1024, 300)])
def test_refine_cuda_matches_plain(cuda, W, indel):
    """Every band tier of refine_alignment_batch, a long deletion
    in the wide tiers, reads of different alen (one 0)."""
    from smartdenovo_tpu_torch.ops.refine import refine_banded_affine

    LA = 600
    *args, _ = refine_inputs(np.random.default_rng(W), 10, LA, W, indel)
    kw = dict(LA=LA, W=W, open_i=-2, open_d=-3)
    n0 = _build.LAUNCHES["refine"]
    got = refine_banded_affine(*(_t(x).to(cuda) for x in args), **kw)
    assert _build.LAUNCHES["refine"] == n0 + 1
    exp = refine_banded_affine(*(_t(x) for x in args), **kw)
    assert_dp_equal(got, exp, args[2], ndirs=1)


@pytest.mark.parametrize("W,indel", [(64, 0), (256, 0), (1024, 300)])
def test_refine5q_cuda_matches_plain(cuda, W, indel):
    from smartdenovo_tpu_torch.ops.refine5q import refine5q_banded

    LA = 600
    rng = np.random.default_rng(W + 5)
    a, b, alen, blen, base, _ = refine_inputs(rng, 10, LA, W, indel)
    args = (a, b, *tracks_for(rng, a), alen, blen, base)
    n0 = _build.LAUNCHES["refine5q"]
    got = refine5q_banded(*(_t(x).to(cuda) for x in args), LA=LA, W=W)
    assert _build.LAUNCHES["refine5q"] == n0 + 1
    exp = refine5q_banded(*(_t(x) for x in args), LA=LA, W=W)
    assert_dp_equal(got, exp, alen, ndirs=1)


def test_refine_alignment_batch_cuda_matches_cpu(cuda):
    """The batch wrappers (band tier, kernel, traceback, stats), affine and
    5q, with a prior CIGAR whose deletion picks W = 512."""
    from smartdenovo_tpu_torch.ops.refine import refine_alignment_batch
    from smartdenovo_tpu_torch.ops.refine5q import refine5q_alignment_batch

    rng = np.random.default_rng(8)
    a, b, alen, blen, _, cigs = refine_inputs(rng, 8, 900, 512, 200)
    pairs = [(a[k, :alen[k]], b[k, :blen[k]]) for k in range(8)
             if alen[k] and blen[k]]
    cigs = [c for k, c in enumerate(cigs) if alen[k] and blen[k]]
    got = refine_alignment_batch(pairs, cigs, device="cuda")
    exp = refine_alignment_batch(pairs, cigs, device="cpu")
    assert got == exp
    quals = quals_for(rng, pairs)
    got = refine5q_alignment_batch(pairs, quals, cigs, device="cuda")
    exp = refine5q_alignment_batch(pairs, quals, cigs, device="cpu")
    assert got == exp


def test_whole_read_consensus_cuda_matches_cpu(cuda):
    """consensus_unitig(seg_engine=False) on the 12 kb unit, one iteration:
    codes and offsets equal on cuda and cpu, through the banded and refine
    kernels."""
    from smartdenovo_tpu_torch.pipeline.cns import CnsParams, consensus_unitig

    unit = unit_12kb()
    p = CnsParams(n_iter=1, seg_engine=False)
    n0 = (_build.LAUNCHES["banded"], _build.LAUNCHES["refine"])
    got = consensus_unitig(unit, p, return_offs=True, device="cuda")
    assert _build.LAUNCHES["banded"] > n0[0]
    assert _build.LAUNCHES["refine"] > n0[1]
    exp = consensus_unitig(unit, p, return_offs=True, device="cpu")
    assert np.array_equal(got[0], exp[0]) and got[1] == exp[1]


def f5q_unit():
    """The f5q unit of tests/test_torch_cns_wholeread.py (tests/test_f5q.py's
    quality-track unit): reads of 2.6 kb every 700 bp of a 6 kb truth at
    10% error, each with seeded 7-track qualities, made here with the
    port's modules alone."""
    from smartdenovo_tpu_torch.pipeline.cns import LayUnitig
    from smartdenovo_tpu_torch.utils.simulate import mutate_read, random_genome

    rng = np.random.default_rng(14)
    truth = random_genome(rng, 6000)
    reads, offs, quals = [], [], []
    for start in range(0, 5200, 700):
        read = mutate_read(rng, truth[start: start + 2600], 0.1)
        q = np.zeros((7, len(read)), np.uint8)
        for t, (lo, hi) in enumerate(((10, 40), (5, 30), (5, 30), (5, 30),
                                      (10, 40), (0, 4), (0, 4))):
            q[t] = rng.integers(lo, hi, len(read))
        reads.append(read)
        offs.append(start)
        quals.append(q)
    return LayUnitig(name="u", reads=reads, offs=offs,
                     backbone=[True] * len(reads), quals=quals)


def test_f5q_consensus_cuda_matches_cpu(cuda):
    """consensus_unitig on the f5q unit, two iterations: the quality-aware
    refine's batch padding, track upload and fetch on the card give the
    CPU run's codes and offsets."""
    from smartdenovo_tpu_torch.pipeline.cns import CnsParams, consensus_unitig

    p = CnsParams(n_iter=2)
    n0 = _build.LAUNCHES["refine5q"]
    got = consensus_unitig(f5q_unit(), p, return_offs=True, device="cuda")
    assert _build.LAUNCHES["refine5q"] > n0
    exp = consensus_unitig(f5q_unit(), p, return_offs=True, device="cpu")
    assert np.array_equal(got[0], exp[0]) and got[1] == exp[1]
