"""Host graph plane: wtclp and wtlay (copies of smartdenovo_tpu/graph)."""
