"""tpusdr_torch.apps — command-line entry points."""
