"""`zmo -G 2 -P 2 -p 1` (the -G passes over every other query) writes the
same .ovl bytes through the port's CLI and the JAX package's, on the bank
of tests/test_torch_gpass.py at batch_q 8 (no budget of the port
overflows)."""

from smartdenovo_tpu.cli import main as jmain
from smartdenovo_tpu.utils.simulate import write_sim_fasta
from smartdenovo_tpu_torch import cli
from smartdenovo_tpu_torch.parallel import gpass

from test_torch_gpass import A, Q, _sim


def test_zmo_gparts_parts_cli_bytes(tmp_path, monkeypatch):
    msgs = []
    monkeypatch.setattr(gpass, "log", lambda m, *a: msgs.append(m % a))
    fa = str(tmp_path / "reads.fa")
    write_sim_fasta(fa, *_sim())
    argv = ["zmo", "-i", fa, "-G", "2", "-P", "2", "-p", "1", "--batch-q",
            str(Q), "-A", str(A)]
    outs = [tmp_path / "port.ovl", tmp_path / "jax.ovl"]
    assert cli.main(argv + ["-o", str(outs[0]), "--device", "cpu"]) == 0
    assert jmain(argv + ["-o", str(outs[1])]) == 0
    assert "gpass: 0 redispatches" in msgs
    got = outs[0].read_bytes()
    assert got.count(b"\n") > 100
    assert got == outs[1].read_bytes()
