"""tpusdr_torch.ops — DSP math on torch tensors (port of tpusdr/ops)."""
