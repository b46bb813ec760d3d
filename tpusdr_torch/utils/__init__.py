"""Host-side helpers (copied from tpusdr/utils: numpy and stdlib only)."""
