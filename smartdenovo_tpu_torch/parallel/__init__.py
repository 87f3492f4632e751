"""The read-block-partitioned overlapper: `-G` passes on one device
(gpass), and the same partition run at once across ranks of
torch.distributed (sharded, multihost)."""
