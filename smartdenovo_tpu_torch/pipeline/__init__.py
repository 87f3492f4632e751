"""Stage drivers: the overlapper and the dmo assembly pipeline."""
