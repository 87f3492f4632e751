"""-G 3 of the port against the JAX package's overlap_gparts, record for
record, on the bank of tests/test_torch_gpass.py at batch_q 8, where no
budget of the port overflows."""

from test_torch_gpass import A, Q, banks, gparts_records  # noqa: F401


def test_gparts3_records_equal_jax(banks, monkeypatch):  # noqa: F811
    jrec, trec, msgs = gparts_records(*banks, monkeypatch, batch_q=Q,
                                      ncand=A, gparts=3)
    assert not [m for m in msgs if "budget overflow" in m]
    assert "gpass: 0 redispatches" in msgs
    assert len(trec) > 300
    assert trec == jrec
