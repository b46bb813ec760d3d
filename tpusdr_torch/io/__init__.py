"""tpusdr_torch.io — host-side sources and sinks."""
