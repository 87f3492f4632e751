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


# ------------------------------------------ the SW (zmo) engine and wtext
# The input makers below are JAX-free; tests/test_torch_swlocal.py feeds the
# same inputs to the JAX package.


def _sw_noisy(rng, s, err):
    """s with err of its bases deleted, duplicated and substituted (a third
    each)."""
    s = s[rng.random(s.size) >= err / 3]
    s = np.repeat(s, 1 + (rng.random(s.size) < err / 3))
    sub = rng.random(s.size) < err / 3
    s = s.copy()
    s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return s


def sw_pairs(rng, B, LA, err=0.13):
    """B overlapping read pairs at err, each cut from one random genome at
    offsets below LA/2, with the chain band (tb, qb, slope) of their true
    diagonal and a slope off by ~1%.  Returns [a, b, alen, blen, tb, qb,
    slope] as numpy (u8, u8, then i32)."""
    G = rng.integers(0, 4, 3 * LA).astype(np.uint8)
    a = np.full((B, LA), 4, np.uint8)
    b = np.full((B, LA), 4, np.uint8)
    alen, blen, tb, qb, sl = (np.zeros(B, np.int32) for _ in range(5))
    for k in range(B):
        x0, y0 = (int(v) for v in rng.integers(0, LA // 2, 2))
        sa = _sw_noisy(rng, G[x0: x0 + int(rng.integers(LA // 2, LA + 1))],
                       err)[:LA]
        sb = _sw_noisy(rng, G[y0: y0 + int(rng.integers(LA // 2, LA + 1))],
                       err)[:LA]
        a[k, :sa.size] = sa
        b[k, :sb.size] = sb
        alen[k], blen[k] = sa.size, sb.size
        tb[k] = max(0, y0 - x0)
        qb[k] = tb[k] + x0 - y0
        sl[k] = int(4096 * (1 + rng.normal(0, 0.01)))
    return [a, b, alen, blen, tb, qb, sl]


def sw_edge_pairs(rng, B, LA, W):
    """sw_pairs (B >= 16) with the DP's edge cases in rows 0-12: alen 0,
    blen 0, blen < W, slope 1 and 4 << 12, negative tb and qb, a dead row
    (tb INT32_MAX, blen 0, as sw_align_batch gives it), N codes in b,
    homopolymer and dinucleotide pairs (ties in the gap scan and in the
    row's argmax), a slope of 3.001 and bands that start left of column 0
    or past the end of b."""
    x = sw_pairs(rng, B, LA)
    a, b, alen, blen, tb, qb, sl = x
    alen[0] = 0
    blen[1] = 0
    blen[2] = W // 2
    sl[3] = 1
    sl[4] = 4 << 12
    tb[5], qb[5] = -100, -60
    tb[6], blen[6] = I32_MAX, 0
    b[7, ::7] = 4
    a[8], b[8], alen[8], blen[8] = 1, 1, LA, LA
    a[9] = np.tile([0, 1], LA // 2)
    b[9] = np.tile([0, 1], LA // 2)
    alen[9], blen[9] = LA, LA
    sl[10] = 3 * 4096 + 5
    tb[11], qb[11] = 50, -400
    sl[12], qb[12] = 4 << 12, 3000
    return x


def sw_live_pairs(rng, B, LA, W):
    """sw_pairs (B >= 24) with the live-row rule's cases in rows 0-23:
    slope 0 inside the columns, pinned at -(W-1) and at blen; negative
    slopes; products and sums that wrap in int32; tb beyond alen (no live
    row, or a few); blen 0; alen > LA; long dead heads (the band left of
    column 1) and dead tails (the band pinned at blen) on the engine's
    slopes 1-4 << 12; blen < W; a dead row as sw_align_batch gives it."""
    x = sw_pairs(rng, B, LA)
    a, b, alen, blen, tb, qb, sl = x
    sl[0], qb[0], tb[0] = 0, W // 2 + 5, 0
    sl[1], qb[1] = 0, -W
    sl[2], qb[2] = 0, int(blen[2]) + W
    sl[3], sl[4] = -(1 << 12), -(3 << 12)
    tb[5], sl[5] = 1 << 30, 64 << 12
    tb[6], sl[6] = -(1 << 30), 4 << 12
    qb[7], sl[7] = I32_MAX - 100, 1 << 12
    tb[8], qb[8], sl[8] = int(alen[8]) + 500, 100, 1 << 12
    tb[9], qb[9], sl[9] = int(alen[9]) - 20, 0, 1 << 12
    blen[10] = 0
    alen[11] = LA + 7
    tb[12], qb[12], sl[12] = 0, -LA // 2, 1 << 12
    tb[13], qb[13], sl[13] = 0, -LA, 4 << 12
    tb[14], qb[14], sl[14] = 0, int(blen[14]) // 2, 4 << 12
    tb[15], qb[15], sl[15] = 0, int(blen[15]) - 30, 1 << 12
    tb[16], qb[16], sl[16] = LA // 3, 0, 2 << 12
    blen[17] = W // 3
    tb[18], blen[18] = I32_MAX, 0
    qb[19], sl[19] = -(1 << 31) + 50, 1 << 12
    sl[20] = (1 << 31) - 1
    tb[21], qb[21], sl[21] = LA // 2, int(blen[21]), 3 * 4096 + 5
    a[22], b[22], alen[22], blen[22] = 1, 1, LA, LA
    tb[22], qb[22], sl[22] = LA // 4, 0, 1 << 12
    sl[23] = 1
    return x


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("kind", ["edge", "random"])
def test_swlocal_cuda_matches_plain(cuda, W, kind):
    from smartdenovo_tpu_torch.ops import overlap_dp

    rng = np.random.default_rng(W + (kind == "edge"))
    x = (sw_edge_pairs(rng, 16, 2048, W) if kind == "edge"
         else sw_pairs(rng, 64, 2048))
    t = [_t(v).to(cuda) for v in x]
    n0 = _build.LAUNCHES["swlocal"]
    got = overlap_dp.banded_local_dp(*t, LA=2048, W=W)
    assert _build.LAUNCHES["swlocal"] == n0 + 1
    exp = overlap_dp.banded_local_dp_plain(*t, LA=2048, W=W)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert int(got[0].max()) > 100


def test_swlocal_cuda_band_shifts(cuda):
    """Band steps of 0-4 columns a row (the engine's slopes) and of any
    size through the API: slopes up to 64 columns a row, negative ones,
    and a product that wraps in int32."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    rng = np.random.default_rng(5)
    x = sw_pairs(rng, 32, 1024)
    x[6] = rng.integers(-(64 << 12), 64 << 12, 32).astype(np.int32)
    x[6][:4] = [0, 1 << 12, 2 << 12, 4 << 12]
    x[4][4:8] = [-(1 << 30), 1 << 30, -7, 1 << 20]
    t = [_t(v).to(cuda) for v in x]
    for W in (32, 96, 256):
        got = overlap_dp.banded_local_dp(*t, LA=1024, W=W)
        exp = overlap_dp.banded_local_dp_plain(*t, LA=1024, W=W)
        for g, e in zip(got, exp):
            assert torch.equal(g, e), W


def test_swlocal_cuda_raises_on_bad_width(cuda):
    """A band no kernel takes raises; W 48, which swlocal does not take,
    goes to swwide."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    t = [_t(v).to(cuda) for v in sw_pairs(np.random.default_rng(1), 2, 256)]
    for W in (0, overlap_dp.SWWIDE_MAX_W + 1):
        with pytest.raises(ValueError):
            overlap_dp.banded_local_dp(*t, LA=256, W=W)
    n0 = dict(_build.LAUNCHES)
    overlap_dp.banded_local_dp(*t, LA=256, W=48)
    assert _build.LAUNCHES["swwide"] == n0["swwide"] + 1
    assert _build.LAUNCHES["swlocal"] == n0["swlocal"]


def _sw_check(x, dev, LA, W=256, gap=-3):
    """The kernel against the plain version on x: bit-equal, one launch of
    swlocal (W a multiple of 32 up to 256) or else of swwide, and none of
    the other."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    t = [_t(v).to(dev) for v in x]
    kernel = "swlocal" if W % 32 == 0 and W <= 256 else "swwide"
    other = "swwide" if kernel == "swlocal" else "swlocal"
    n0 = dict(_build.LAUNCHES)
    got = overlap_dp.banded_local_dp(*t, LA=LA, W=W, gap=gap)
    assert _build.LAUNCHES[kernel] == n0[kernel] + 1
    assert _build.LAUNCHES[other] == n0[other]
    exp = overlap_dp.banded_local_dp_plain(*t, LA=LA, W=W, gap=gap)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    return [g.cpu().numpy() for g in got]


@pytest.mark.parametrize("W", [32, 96, 256])
def test_swlocal_cuda_live_rows(cuda, W):
    """The live-row rule's cases (sw_live_pairs): slope 0, negative and
    wrapping bands, dead heads and tails, tb beyond alen, blen 0."""
    _sw_check(sw_live_pairs(np.random.default_rng(40 + W), 40, 1024, W), cuda,
              1024, W)


@pytest.mark.parametrize("gap", [0, 1])
def test_swlocal_cuda_gap(cuda, gap):
    """The live-row rule's cases at a gap of 0 (the tail is still cut) and
    +1 (a pinned tail row raises the best, so the tail stays)."""
    _sw_check(sw_live_pairs(np.random.default_rng(45 + gap), 40, 1024, 256),
              cuda, 1024, gap=gap)


def test_swlocal_cuda_mixed_lengths(cuda):
    """37 pairs (not a multiple of a block's warps) of lengths 1 .. LA."""
    rng = np.random.default_rng(51)
    x = sw_pairs(rng, 37, 2048)
    x[2][:] = np.minimum(x[2], rng.integers(1, 2049, 37))
    x[2][:3] = [1, 2, 2048]
    _sw_check(x, cuda, 2048)


def test_swlocal_cuda_one_pair(cuda):
    x = sw_pairs(np.random.default_rng(60), 1, 1024)
    assert _sw_check(x, cuda, 1024)[0][0] > 100


def test_swlocal_cuda_more_pairs_than_warps(cuda):
    """6,000 pairs: the counter hands each of the grid's warps (4 a SM)
    several pairs."""
    x = sw_pairs(np.random.default_rng(61), 6000, 256)
    assert (_sw_check(x, cuda, 256)[0] > 0).sum() > 5000


def sw_tie_pairs(rng, LA=512, W=256, L=40):
    """Four pairs whose best score 2 L is reached at several cells, with a
    band of slope 0 over columns 0 .. W-1: (0) one row, two columns; (1)
    two rows, one column; (2) two rows and two columns each; (3) the later
    row at the lower column.  The JAX order picks the earliest row, then
    its lowest column: (L, L), (L, L), (L, L), (L, 100).  Every other code
    is 4, which matches nothing, so no path scores more."""
    X, Y = (rng.integers(0, 4, L).astype(np.uint8) for _ in range(2))
    R = lambda n: np.full(n, 4, np.uint8)  # noqa: E731
    seqs = [(X, np.concatenate([X, R(60), X])),
            (np.concatenate([X, R(60), X]), X),
            (np.concatenate([X, R(60), X]), np.concatenate([X, R(90), X])),
            (np.concatenate([Y, R(60), X]), np.concatenate([X, R(20), Y]))]
    B = len(seqs)
    a = R(B * LA).reshape(B, LA)
    b = R(B * LA).reshape(B, LA)
    for k, (sa, sb) in enumerate(seqs):
        a[k, :sa.size] = sa
        b[k, :sb.size] = sb
    full = np.full(B, LA, np.int32)
    zero = np.zeros(B, np.int32)
    return [a, b, full, full.copy(), zero, zero + W // 2, zero.copy()]


def test_swlocal_cuda_tied_bests(cuda):
    """Ties of the best score at other rows and columns: the earliest row,
    then the lowest column, whatever lane or row reaches them first."""
    for seed in range(4):
        got = _sw_check(sw_tie_pairs(np.random.default_rng(70 + seed)), cuda,
                        512)
        assert (got[0] == 80).all()
        assert got[2].tolist() == [40] * 4
        assert got[3].tolist() == [40, 40, 40, 100]


def test_swlocal_cuda_wtgbo_batch(cuda):
    """A batch of wtgbo's shape: 16 queries x 32 candidates x 2 passes,
    most slots dead (tb INT32_MAX, blen 0, as sw_align_batch gives them)."""
    rng = np.random.default_rng(62)
    x = sw_pairs(rng, 1024, 2048)
    dead = rng.random(1024) > 0.1
    x[4][dead], x[3][dead], x[5][dead] = I32_MAX, 0, 0
    got = _sw_check(x, cuda, 2048)
    assert (got[0][dead] == 0).all() and (got[0][~dead] > 100).all()


# ------------------------------------------ the wide band (csrc/swwide.cu)


@pytest.mark.parametrize("W", [1600, 100, 288, 2048])
@pytest.mark.parametrize("kind", ["edge", "random"])
def test_swwide_cuda_matches_plain(cuda, W, kind):
    """swwide against its plain version at wtcyc's W 1600, at a W that is
    no multiple of 32, one past swlocal's largest and a 2,048-lane band:
    random pairs and the DP's edge cases (alen or blen 0, dead rows,
    slopes of 0-4 columns a row and more, bands left of column 0 or past
    blen, N codes, homopolymers)."""
    rng = np.random.default_rng(W + (kind == "edge"))
    x = (sw_edge_pairs(rng, 16, 2048, W) if kind == "edge"
         else sw_pairs(rng, 48, 2048))
    got = _sw_check(x, cuda, 2048, W)
    assert got[0].max() > 100


@pytest.mark.parametrize("W", [1600, 100])
def test_swwide_cuda_live_rows(cuda, W):
    _sw_check(sw_live_pairs(np.random.default_rng(80 + W), 40, 1024, W), cuda,
              1024, W)


@pytest.mark.parametrize("gap", [0, 1])
def test_swwide_cuda_gap(cuda, gap):
    _sw_check(sw_live_pairs(np.random.default_rng(85 + gap), 40, 1024, 1600),
              cuda, 1024, 1600, gap=gap)


def test_swwide_cuda_tied_bests(cuda):
    """Ties of the best score at other rows and columns, at W 1600 and 100
    (the band over columns 0 .. W-1): the earliest row, then the lowest
    column, whatever thread or warp reaches them first.  At W 100 pair 3's
    earlier tie ends at column 100, outside the band, so its later one
    (row 140, column 40) is the only best."""
    for W, rows, cols in ((1600, [40] * 4, [40, 40, 40, 100]),
                          (100, [40, 40, 40, 140], [40] * 4)):
        for seed in range(2):
            got = _sw_check(sw_tie_pairs(np.random.default_rng(90 + seed),
                                         W=W), cuda, 512, W)
            assert (got[0] == 80).all()
            assert got[2].tolist() == rows
            assert got[3].tolist() == cols


def sw_spread_tie_pairs(rng, LA, W, sep, far, L=40):
    """sw_tie_pairs' four cases with the copies far apart, so that the tied
    cells fall in different threads and warps: (0) one row, columns L and
    2 L + sep; (1) rows L and 2 L + sep, one column; (2) both; (3) row L
    at column 2 L + far against row 2 L + sep at column L.  The band (tb 0,
    qb W/2, the given slope, 0 by default) starts at column 0: at slope 0
    the JAX order gives scores 2 L at rows L and columns (L, L, L, 2 L +
    far)."""
    X, Y = (rng.integers(0, 4, L).astype(np.uint8) for _ in range(2))
    R = lambda n: np.full(n, 4, np.uint8)  # noqa: E731
    seqs = [(X, np.concatenate([X, R(sep), X])),
            (np.concatenate([X, R(sep), X]), X),
            (np.concatenate([X, R(sep), X]), np.concatenate([X, R(sep), X])),
            (np.concatenate([Y, R(sep), X]), np.concatenate([X, R(far), Y]))]
    a = np.full((4, LA), 4, np.uint8)
    b = np.full((4, LA), 4, np.uint8)
    for k, (sa, sb) in enumerate(seqs):
        a[k, :sa.size] = sa
        b[k, :sb.size] = sb
    full = np.full(4, LA, np.int32)
    zero = np.zeros(4, np.int32)
    return [a, b, full, full.copy(), zero, zero + W // 2, zero.copy()]


@pytest.mark.parametrize("W,sep,far", [(1600, 300, 620), (160, 50, 70)])
def test_swwide_cuda_ties_across_warps(cuda, W, sep, far):
    """Tied bests in different warps (W 1600: 320 lanes a warp) or threads
    (W 160: one warp of 5 lanes a thread): the earliest row, then the
    lowest column, whichever warp holds it, on a band of step 0 and of
    step 1 (1 << 12, where the copies move across the band)."""
    x = sw_spread_tie_pairs(np.random.default_rng(W), 1024, W, sep, far)
    got = _sw_check(x, cuda, 1024, W)
    assert (got[0] == 80).all() and got[2].tolist() == [40] * 4
    assert got[3].tolist() == [40, 40, 40, 80 + far]
    x[6][:] = 1 << 12
    _sw_check(x, cuda, 1024, W)


@pytest.mark.parametrize("W", [1, 33, 100, 288, 1600, 2048, 4096])
def test_swwide_cuda_block_shapes(cuda, W):
    """Each block shape of swwide_shape (W 1: one warp of 1 lane a thread;
    33: 2; 100: 4; 288: 9; 1600: 5 warps of 10; 2048: 8 of 8; 4096: 16 of
    8) on the DP's edge cases and the live-row rule's, both paths in one
    call."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    rng = np.random.default_rng(100 + W)
    x = [np.concatenate(v) for v in zip(sw_edge_pairs(rng, 16, 1024, W),
                                        sw_live_pairs(rng, 24, 1024, W))]
    unit = overlap_dp.unit_steps(*(_t(v) for v in x[2:]), 1024, W)
    assert 0 < int(unit.sum()) < unit.numel()
    assert _sw_check(x, cuda, 1024, W)[0].max() > 100


def test_swwide_cuda_cyc_shapes(cuda):
    """`cyc`'s own calls at W 1600 (rc(read) against read, slope 1 << 12
    from (0, 0): the unit path), at lengths of 100 to 3,000 bp that fill
    neither a warp's 320 lanes nor the band, palindromes among them."""
    from smartdenovo_tpu_torch.data.readbank import revcomp_codes
    from smartdenovo_tpu_torch.ops import overlap_dp
    from smartdenovo_tpu_torch.pipeline.aln_tools import local_chunks, local_inputs

    rng = np.random.default_rng(110)
    reads = []
    for k, n in enumerate([100, 150, 319, 321, 640, 799, 801, 1599, 1601, 2000,
                           2500, 3000]):
        s = rng.integers(0, 4, n).astype(np.uint8)
        if k % 3 == 0:   # a palindrome at 3% substitutions
            s = np.concatenate([s[:n // 2], revcomp_codes(s[:n - n // 2])])
            sub = rng.random(n) < 0.03
            s[sub] = (s[sub] + 1) % 4
        reads.append(s)
    pairs = [(revcomp_codes(s), s) for s in reads]
    best = []
    for idx, LA in local_chunks(pairs):
        x = [v.numpy() for v in local_inputs([pairs[k] for k in idx], LA, "cpu")]
        assert overlap_dp.unit_steps(*(_t(v) for v in x[2:]), LA, 1600).all()
        best += list(_sw_check(x, cuda, LA, 1600)[0])
    assert max(best) >= 400


def test_swwide_cuda_mixed_paths(cuda):
    """One call of pairs on the unit path (slopes 0 to 1 << 12) and on the
    shared-memory path (slopes past 1 << 12, negative ones), at W 1600 and
    W 100."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    rng = np.random.default_rng(120)
    x = sw_pairs(rng, 48, 1024)
    x[6][:] = rng.choice([0, 1, 2048, 4095, 4096, 4097, 6000, 8192, 3 << 12,
                          -4096], 48)
    x[6][:2] = [4096, 8192]
    for W in (1600, 100):
        unit = overlap_dp.unit_steps(*(_t(v) for v in x[2:]), 1024, W)
        assert 10 < int(unit.sum()) < 38
        assert (_sw_check(x, cuda, 1024, W)[0] > 0).sum() > 10


def test_swwide_cuda_raises_outside_its_scores(cuda):
    """swwide's scan keys hold scores under 2^24 and |gap| <= 4096; a call
    outside that raises."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    t = [_t(v).to(cuda) for v in sw_pairs(np.random.default_rng(2), 2, 256)]
    for kw in (dict(gap=-5000), dict(match=1 << 17), dict(gap=100)):
        with pytest.raises(ValueError):
            overlap_dp.banded_local_dp(*t, LA=256, W=1600, **kw)


def test_swwide_cuda_one_pair_and_many(cuda):
    """B 1, and 300 pairs of mixed lengths (at most one a block at W 1600;
    test_swwide_cuda_more_pairs_than_blocks makes the blocks loop)."""
    x = sw_pairs(np.random.default_rng(95), 1, 1024)
    assert _sw_check(x, cuda, 1024, 1600)[0][0] > 100
    rng = np.random.default_rng(96)
    x = sw_pairs(rng, 300, 1024)
    x[2][:] = np.minimum(x[2], rng.integers(1, 1025, 300))
    assert (_sw_check(x, cuda, 1024, 1600)[0] > 0).sum() > 250


def test_swwide_cuda_more_pairs_than_blocks(cuda):
    """4,000 short pairs at W 1600, three times the most blocks the grid
    can hold (8 of 256 threads a SM), so every block takes several pairs
    from the counter: full pairs, pairs of mixed lengths, pairs with alen
    or blen 0 and pairs with no live row (a band left of column 1 in
    every row) in one call."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    B, LA, W = 4000, 256, 1600
    nsm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert B > 3 * nsm * (2048 // 256)
    rng = np.random.default_rng(94)
    x = sw_pairs(rng, B, LA)
    x[2][:] = np.minimum(x[2], rng.integers(1, LA + 1, B))
    x[2][::7] = 0
    x[3][3::11] = 0
    dead = np.arange(5, B, 13)
    x[4][dead], x[5][dead], x[6][dead] = 0, -4 * LA, 0
    t = [_t(v) for v in x[2:]]
    i0, i1 = overlap_dp.live_rows(*t, LA, W)
    assert (i1[torch.from_numpy(dead)] < i0[torch.from_numpy(dead)]).all()
    got = _sw_check(x, cuda, LA, W)
    assert (got[0][dead] == 0).all() and (got[0][::7] == 0).all()
    assert (got[0] > 0).sum() > B // 2


def test_swwide_cuda_widest_band(cuda):
    """The widest band swwide takes (dynamic shared memory past 48 KB)."""
    from smartdenovo_tpu_torch.ops import overlap_dp

    x = sw_pairs(np.random.default_rng(97), 8, 4096)
    _sw_check(x, cuda, 4096, overlap_dp.SWWIDE_MAX_W)


def test_banded_local_dp_w256_stays_on_swlocal(cuda):
    x = sw_pairs(np.random.default_rng(98), 8, 1024)
    _sw_check(x, cuda, 1024, 256)


def _tool_inputs(d):
    """FASTA inputs of cyc (two palindromes, one off centre, and plain
    reads) and dif (a reference and reads with a substitution, an
    insertion and a deletion, in two length tiers)."""
    from smartdenovo_tpu_torch.data.readbank import codes_to_seq, revcomp_codes

    rng = np.random.default_rng(99)
    half = rng.integers(0, 4, 900).astype(np.uint8)
    arm = rng.integers(0, 4, 1500).astype(np.uint8)
    cyc = [("pal", np.concatenate([half, revcomp_codes(half)])),
           ("off", np.concatenate([arm, revcomp_codes(arm[700:])]))]
    cyc += [(f"r{k}", rng.integers(0, 4, int(rng.integers(300, 3000)))
             .astype(np.uint8)) for k in range(10)]
    ref = rng.integers(0, 4, 3000).astype(np.uint8)
    dif = [("ref", ref)]
    for k in range(6):
        r = ref[:int(rng.integers(400, 3000))].copy()
        r[100 + k] = (r[100 + k] + 1) % 4
        r = np.delete(np.insert(r, 200, 2), 300 + k)
        dif.append((f"d{k}", r))
    for name, recs in (("cyc", cyc), ("dif", dif)):
        with open(d / f"{name}.fa", "w") as fh:
            fh.write("".join(f">{n}\n{codes_to_seq(s)}\n" for n, s in recs))
    return str(d / "cyc.fa"), str(d / "dif.fa")


def test_cyc_and_dif_cuda_match_cpu(cuda, tmp_path):
    """`cyc` (swwide, W 1600) and `dif` (banded) through the CLI on cuda
    and on cpu: the same bytes, each kernel launched."""
    import contextlib
    import io

    from smartdenovo_tpu_torch import cli

    cyc_fa, dif_fa = _tool_inputs(tmp_path)
    outs = {}
    for dev in ("cuda", "cpu"):
        n0 = dict(_build.LAUNCHES)
        cli.main(["cyc", cyc_fa, "-o", str(tmp_path / f"{dev}.obt"),
                  "--device", dev])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["dif", dif_fa, "--device", dev])
        outs[dev] = ((tmp_path / f"{dev}.obt").read_text(), buf.getvalue())
        if dev == "cuda":
            assert _build.LAUNCHES["swwide"] > n0["swwide"]
            assert _build.LAUNCHES["banded"] > n0["banded"]
    assert outs["cuda"] == outs["cpu"]
    rows = dict(r.split("\t", 1) for r in outs["cuda"][0].splitlines())
    assert rows["pal"] == "0\t900\t1800" and rows["r0"].startswith("0\t")
    assert outs["cuda"][1].count("\tS\t") >= 6


def sw_bank():
    """About 8 kb of genome at 6x, reads of 600 to 2,000 bp (the SW engine
    tests' simulation): names and code arrays."""
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(7)
    g = random_genome(rng, 8000)
    names, seqs = simulate_reads(g, coverage=6, mean_len=1200, err=0.13,
                                 seed=8, min_len=600)
    return names, [s[:2000] for s in seqs]


SW_PARAMS = dict(batch_q=4, ncand=16, align_cap=8, band_w=64)


@pytest.mark.parametrize("refine", [False, True])
def test_overlap_reads_sw_cuda_matches_cpu(cuda, refine):
    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_reads

    rb = ReadBank(*sw_bank())
    p = ZmoParams.zmo(refine=refine, **SW_PARAMS)
    _build.reset_launches()
    got = overlap_reads(rb, p, progress=False, device="cuda")
    launches = dict(_build.LAUNCHES)
    exp = overlap_reads(rb, p, progress=False, device="cpu")
    assert got == exp and len(got) > 30
    assert launches["swlocal"] > 0 and launches["banded"] > 0
    assert (launches["refine"] > 0) == refine


def test_rescue_and_ext_cuda_match_cpu(cuda):
    """wtgbo's rescue with every third overlap dropped, and wtext on the
    shrunk overlaps and on dm records (placeholder cores: the refine
    kernel), on cuda and on cpu."""
    import dataclasses

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.graph.gbo import GboParams, rescue_overlaps
    from smartdenovo_tpu_torch.pipeline.ext import ExtParams, run_ext
    from smartdenovo_tpu_torch.pipeline.zmo import (ZmoParams, overlap_dmo,
                                                    overlap_reads)

    rb = ReadBank(*sw_bank())
    ovls = overlap_reads(rb, ZmoParams.zmo(**SW_PARAMS), progress=False,
                         device="cuda")
    kept = [o for k, o in enumerate(ovls) if k % 3]
    gp = GboParams(batch_q=4, cand_cap=8, band_w=64)
    n0 = _build.LAUNCHES["swlocal"]
    got = rescue_overlaps(rb, kept, gp, device="cuda")
    assert _build.LAUNCHES["swlocal"] > n0
    assert got == rescue_overlaps(rb, kept, gp, device="cpu") and got
    shrunk = [dataclasses.replace(o, beg1=o.beg1 + 200, end1=o.end1 - 200,
                                  beg2=o.beg2 + 200, end2=o.end2 - 200,
                                  cigar=f"{max(o.end1 - o.beg1, o.end2 - o.beg2) - 400}M")
              for o in ovls[:20]
              if min(o.end1 - o.beg1, o.end2 - o.beg2) > 600]
    dm = overlap_dmo(rb, ZmoParams.dmo(batch_q=8, ncand=32), progress=False,
                     device="cuda")[:30]
    ep = ExtParams(band_w=64)
    for recs in (shrunk, dm):
        n0 = dict(_build.LAUNCHES)
        got = run_ext(rb, recs, params=ep, device="cuda")
        assert _build.LAUNCHES["banded"] > n0["banded"]
        assert got == run_ext(rb, recs, params=ep, device="cpu") and got
    assert _build.LAUNCHES["refine"] > n0["refine"]


def _gpass_bank():
    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(11)
    return ReadBank(*simulate_reads(random_genome(rng, 30000), coverage=10,
                                    mean_len=5000, err=0.13, seed=12))


@pytest.mark.parametrize("G", [2, 3])
def test_gparts_cuda_matches_cpu(cuda, G):
    """-G on the card: records equal to the CPU's, K1 launched."""
    import dataclasses

    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    rb = _gpass_bank()
    p = ZmoParams.dmo(batch_q=8, ncand=64, gparts=G)
    n0 = _build.LAUNCHES["sseg"]
    got = [dataclasses.astuple(o)
           for o in overlap_dmo(rb, p, progress=False, device=cuda)]
    assert _build.LAUNCHES["sseg"] > n0
    exp = [dataclasses.astuple(o)
           for o in overlap_dmo(rb, p, progress=False, device="cpu")]
    assert len(got) > 300 and got == exp


def test_sharded_gloo_on_one_card_matches_cpu(cuda):
    """Two gloo ranks sharing the card give the records of the same world
    on the CPU (the dry run's sim at 30 kb)."""
    from smartdenovo_tpu_torch import graft_entry
    from smartdenovo_tpu_torch.parallel.multihost import run_local_world

    kw = dict(ncand=64, batch_q=4)
    got = run_local_world(graft_entry.sharded_rank, 2, "gloo", 30_000, 42,
                          kw, 1, "cuda:0")
    exp = run_local_world(graft_entry.sharded_rank, 2, "gloo", 30_000, 42,
                          kw, 1, "cpu")
    assert got[0] == got[1] and len(got[0]) > 100
    assert got[0] == exp[0]


def test_sharded_nccl_world_of_one_matches_overlap_dmo(cuda):
    import dataclasses

    from smartdenovo_tpu_torch import graft_entry
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    got = graft_entry.dryrun_multichip(1, "nccl", "cuda", genome_len=30_000)
    exp = [dataclasses.astuple(o) for o in overlap_dmo(
        graft_entry.sim_bank(30_000), ZmoParams.dmo(ncand=64, batch_q=2),
        progress=False, device=cuda)]
    assert got == exp


def test_graft_entry_forward_cuda_matches_cpu(cuda):
    from smartdenovo_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device=cuda)
    got = [o.cpu() for o in fn(*args)]
    fn, args = graft_entry.entry(device="cpu")
    exp = fn(*args)
    assert len(got) == 8
    for k, (g, e) in enumerate(zip(got, exp)):
        assert torch.equal(g, e), k


# ------------------------------------------------------ global NW (nwglobal)
# tests/test_torch_swdp.py feeds the same inputs to the JAX package.


def nw_pairs(rng, B, L, err=0.13):
    """B pairs of windows of L codes: a read and a mutated copy of it, at
    lengths from 0 to L, unequal, some with an N (code 4) inside; the last
    pair has alen L, and from B = 6 on the first three have alen 0, blen 0
    or both (lengths 5 and 7 cut to L)."""
    from smartdenovo_tpu_torch.utils.simulate import mutate_read

    a = np.full((B, L), 4, np.uint8)
    b = np.full((B, L), 4, np.uint8)
    alen = rng.integers(0, L + 1, B).astype(np.int32)
    blen = rng.integers(0, L + 1, B).astype(np.int32)
    alen[-1] = L
    if B >= 6:
        alen[:3] = (0, min(5, L), 0)
        blen[:3] = (min(7, L), 0, 0)
    for k in range(B):
        src = rng.integers(0, 4, L).astype(np.uint8)
        a[k, :alen[k]] = src[:alen[k]]
        mut = mutate_read(rng, src, err)[:L]
        n = min(int(blen[k]), len(mut))
        blen[k] = n
        b[k, :n] = mut[:n]
        if k % 4 == 1 and alen[k] > 2:
            a[k, alen[k] // 2] = 4
        if k % 4 == 2 and n > 2:
            b[k, n // 3] = 4
    return a, b, alen, blen


def _nw_check(cuda, x, L, **scores):
    """batch_global_align on the card against its plain version on the
    same device tensors: scores and every byte of the plane; one launch."""
    from smartdenovo_tpu_torch.ops import swdp

    args = [_t(v).to(cuda) for v in x]
    n0 = _build.LAUNCHES["nwglobal"]
    got = swdp.batch_global_align(*args, max_len=L, **scores)
    assert _build.LAUNCHES["nwglobal"] == n0 + 1
    exp = swdp.batch_global_align_plain(*args, max_len=L, **scores)
    torch.cuda.synchronize()
    assert torch.equal(got[0], exp[0])
    assert torch.equal(got[1], exp[1])
    return exp[0].cpu()


@pytest.mark.parametrize("L,B,path", [(256, 24, "shared"), (256, 24, "global"),
                                      (19_370, 2, "global")])
def test_nwglobal_cuda_matches_plain(cuda, L, B, path, monkeypatch):
    """The wide instance: its three diagonals in shared memory (L 256,
    where the register instance is set aside), in the global scratch
    (forced at L 256), and at L 19,370, the first L past shared memory."""
    from smartdenovo_tpu_torch.ops import swdp

    if L <= swdp.NW_REG_MAX_L:
        monkeypatch.setattr(swdp, "NW_REG_MAX_L", 0)
    if path == "global" and L == 256:
        monkeypatch.setattr(swdp, "NW_SMEM_CAP", 0)
    assert swdp.nw_plan(L, B) == ("wide", path == "shared")
    _nw_check(cuda, nw_pairs(np.random.default_rng(L + B), B, L), L)


def _nw_shape_firsts(B, top):
    """The first L of each shape nw_shape picks for B pairs, up to top."""
    from smartdenovo_tpu_torch.ops import swdp

    out, prev = [], None
    for L in range(1, top + 1):
        shape = swdp.nw_shape(L, B)
        if shape != prev:
            out.append(L)
            prev = shape
    return out


def _nw_shape_cases():
    from smartdenovo_tpu_torch.ops import swdp

    top = swdp.NW_REG_MAX_L
    # B 24 spreads a pair over warps (the DAG loop's B); B 600 keeps one
    # warp a pair up to P 32 (phase 3's regime); the last L of a few
    # shapes fill their rows exactly; then the wide instance's first L
    cases = [(L, 24) for L in _nw_shape_firsts(24, top)]
    cases += [(L, 600) for L in _nw_shape_firsts(600, 1023) if L > 128]
    cases += [(31, 24), (511, 24), (2047, 24), (1023, 600), (top + 1, 2)]
    return cases


@pytest.mark.parametrize("L,B", _nw_shape_cases())
def test_nwglobal_cuda_shapes(cuda, L, B):
    """Every shape nw_shape picks, at the first L it takes (its last
    strip's rows least filled) and at a few last L (filled exactly), on
    nw_pairs (random lengths, alen / blen 0 and both, N codes inside),
    and the first L of the wide instance."""
    from smartdenovo_tpu_torch.ops import swdp

    plan = swdp.nw_plan(L, B)
    assert (plan[0] == "register") == (L <= swdp.NW_REG_MAX_L)
    _nw_check(cuda, nw_pairs(np.random.default_rng(3 * L + B), B, L), L)


def test_nwglobal_cuda_phase3_batch(cuda):
    """B 2,048 at L 512, more pairs than warps resident at once: one warp
    a pair (P 17), 8 pairs a block, and the last of 256 blocks full."""
    from smartdenovo_tpu_torch.ops import swdp

    assert swdp.nw_plan(512, 2048) == ("register", 17, 1, 8)
    x = nw_pairs(np.random.default_rng(2048), 2048, 512, err=0.13)
    _nw_check(cuda, x, 512)


@pytest.mark.parametrize("L,B", [(300, 16), (300, 600), (2048, 24)])
def test_nwglobal_cuda_live_edges(cuda, L, B):
    """Pairs whose live rows start and end inside a group of 32 rows, on
    one, and at a strip's edges: alen and blen at the group and strip
    boundaries and one either side, 0 and L among them."""
    from smartdenovo_tpu_torch.ops import swdp

    P, warps, _ = swdp.nw_shape(L, B)
    strip = 32 * P
    edges = sorted({min(max(e + o, 0), L) for e in
                    (0, 32, 64, strip, 2 * strip, L) for o in (-1, 0, 1)})
    a, b, alen, blen = nw_pairs(np.random.default_rng(L + 7), B, L)
    alen[:] = [edges[k % len(edges)] for k in range(B)]
    blen[:] = [edges[(3 * k + 1) % len(edges)] for k in range(B)]
    assert (warps > 1) == (B < 528)
    _nw_check(cuda, (a, b, alen, blen), L)


@pytest.mark.parametrize("L,B", [(512, 64), (2048, 24)])
def test_nwglobal_cuda_other_scores(cuda, L, B):
    """match 1, mismatch -2, gap -2 (more ties than the defaults)."""
    x = nw_pairs(np.random.default_rng(L - B), B, L)
    _nw_check(cuda, x, L, match=1, mismatch=-2, gap=-2)


def test_nwglobal_cuda_zero_lengths(cuda):
    """alen 0, blen 0 and both, at the register instance's one-warp and
    many-warp shapes: the first row or column only, and the origin."""
    for L, B in ((40, 600), (2048, 24)):
        x = nw_pairs(np.random.default_rng(L), B, L)
        x[2][: B // 3] = 0
        x[3][B // 3: 2 * B // 3] = 0
        x[2][-3:] = 0
        x[3][-3:] = 0
        score = _nw_check(cuda, x, L)
        assert (score[-3:] == 0).all()


@pytest.mark.parametrize("engine", ["dm", "sw"])
def test_overlap_vtab_cuda_matches_cpu(cuda, engine):
    """matcher="vtab" on the card: records equal to the CPU's, K1 (and
    under sw the SW local DP) launched."""
    import dataclasses

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    if engine == "dm":
        rb = _gpass_bank()
        p = ZmoParams.dmo(batch_q=8, ncand=64, matcher="vtab")
    else:
        rb = ReadBank(*sw_bank())
        p = ZmoParams.zmo(matcher="vtab", **SW_PARAMS)
    _build.reset_launches()
    got = [dataclasses.astuple(o)
           for o in overlap_dmo(rb, p, progress=False, device=cuda)]
    launches = dict(_build.LAUNCHES)
    exp = [dataclasses.astuple(o)
           for o in overlap_dmo(rb, p, progress=False, device="cpu")]
    assert len(got) > 30 and got == exp
    assert launches["sseg"] > 0
    assert launches["jpost"] == launches["pexpand"] == 0
    if engine == "sw":
        assert launches["swlocal"] > 0
