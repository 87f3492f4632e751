"""-G 3 at batch_q 16 on the bank of tests/test_torch_gpass.py: pass 1's
candidate expansion of a batch outgrows the part's posting total, the
JAX package's budget for it (parallel/gpass.py:227-239 discards the
counter and truncates); the port redispatches the batch at a grown budget
instead, so its records are those of a run whose pass-1 budget is large
enough from the start, and differ from the JAX package's."""

from smartdenovo_tpu_torch.parallel import gpass
from smartdenovo_tpu_torch.pipeline import zmo as tzmo

from test_torch_gpass import A, _records, banks, gparts_records  # noqa: F401

KW = dict(batch_q=16, ncand=A, gparts=3)


def test_pass1_overflow_redispatches(banks, monkeypatch):  # noqa: F811
    jrec, trec, msgs = gparts_records(*banks, monkeypatch, **KW)
    over = [m for m in msgs if "budget overflow" in m]
    assert over and all("pass 1" in m and "cbud" in m for m in over), msgs
    # the same code with a pass-1 budget that fits from the start
    wide = gpass._pass1_budgets
    monkeypatch.setattr(
        gpass, "_pass1_budgets",
        lambda n_post, Q, Ltier, p: (1 << 20, wide(n_post, Q, Ltier, p)[1]))
    msgs.clear()
    ref = _records(tzmo.overlap_dmo(banks[1], tzmo.ZmoParams.dmo(**KW),
                                    progress=True, device="cpu"))
    assert "gpass: 0 redispatches" in msgs
    assert trec == ref
    # the JAX package truncated the expansion: its records differ
    assert jrec != trec
