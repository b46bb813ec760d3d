"""tpusdr_torch.models — complete receiver pipelines."""

from tpusdr_torch.models.receiver import (  # noqa: F401
    AM,
    NBFM,
    WBFM,
    ReceiverSpec,
    am_receiver,
    fm_receiver,
    rf_to_pcm,
)
from tpusdr_torch.models.multichannel import fm_channel_bank, nbfm_channels  # noqa: F401
