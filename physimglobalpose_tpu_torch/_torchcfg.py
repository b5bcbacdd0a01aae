"""Central PyTorch configuration, imported by every torch-using module.

The counterpart of the JAX package's _jaxcfg.py: geometric code (SE(3)
composition, rigid fits, distance expansions) needs true fp32 products. On
the card, TF32 would put noise of ~1e-3 relative into every matmul, far above
the LCP match radius delta^2 = 2.5e-5 m^2, so TF32 is switched off for both
matmuls and cuDNN.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when the card is asked for and absent - the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe_device(device: torch.device) -> dict:
    """What a measurement ran on: {"device": "cpu"} or, for a card, its name
    and the name and power limit as nvidia-smi reports them (None where
    nvidia-smi cannot be run)."""
    if device.type != "cuda":
        return {"device": "cpu"}
    import subprocess

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30,
        ).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}
