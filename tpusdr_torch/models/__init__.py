"""tpusdr_torch.models — complete receiver pipelines."""

from tpusdr_torch.models.receiver import NBFM, WBFM, ReceiverSpec, fm_receiver  # noqa: F401
