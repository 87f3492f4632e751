"""Host utilities: logging, the native engines' loader, the read simulator."""
