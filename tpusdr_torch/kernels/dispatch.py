"""Where a kernel wrapper sends its call.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written kernel, or the call raises.  There is no switch
that swaps the plain version in on the card and no fallback on a failed
build or launch.
"""

from __future__ import annotations

import torch


def on_cuda(*tensors: torch.Tensor | None) -> bool:
    """True if every given tensor is on a CUDA device (launch the kernel),
    False if every one is on the CPU (run the plain version)."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(
        f"tensors on {sorted(kinds)}: a kernel wrapper takes all-CUDA "
        "tensors (kernel) or all-CPU tensors (plain version)"
    )


def launch_target(t: torch.Tensor, smem_bytes: int, name: str) -> tuple[int, int]:
    """(device index, current stream handle) for a launch on t's device,
    after checking that one block's shared memory fits the card."""
    from tpusdr_torch.kernels.build import library

    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    limit = library().tpusdr_max_smem_optin(dev)
    if smem_bytes > limit:
        raise ValueError(
            f"{name}: needs {smem_bytes} B of shared memory per block; "
            f"the card allows {limit}"
        )
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        from tpusdr_torch.kernels.build import library

        msg = library().tpusdr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
