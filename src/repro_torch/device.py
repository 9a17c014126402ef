"""Device resolution and the IEEE-f32 switches of the port.

Entry points run on the CUDA card unless the caller asks for the CPU.
With no card and no explicit request they raise: a silent CPU run would
pass off the plain PyTorch path as the kernels' result.

f32 means IEEE f32. A TF32 matmul moves a score by about 1e-3 relative,
which flips bucketize indices at thresholds, so TF32 stays off for
matmuls and convolutions and the matmul precision stays "highest".
Products of bf16 operands (the LM substrate's) reduce in f32, as the
reference's do: cuBLAS may not sum their split-K parts in bf16.
"""
from __future__ import annotations

import torch


def ieee_f32() -> None:
    """Keep every f32 product of the process in full IEEE f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, which must
    then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
