"""peanut_tpu_torch — the PyTorch/CUDA port of peanut_tpu for one NVIDIA H100.

The JAX package ``peanut_tpu`` stays the reference.  This package mirrors its
layout module for module, imports ``torch`` and numpy and never JAX nor any
module of ``peanut_tpu``, and replaces each Pallas TPU kernel on its path with
a CUDA C++ kernel built for ``sm_90a`` at first use (``kernels/csrc``).

Layering (bottom-up), as in the JAX package:
  geometry/   camera + pose math
  kernels/    splat, grid-sample warp, morphology (torch built-ins) and the
              eikonal solver, whose two TPU kernels are CUDA kernels here
  mapping/    per-step semantic map update
  perception/ depth preprocessing + ground-truth segmenters
  planning/   FMM planner host code, untrap state machine
  agent/      batched ops + the batched parallel-episode runtime
  envs/       synthetic environments + the batch runner

Device rule: entry points take ``device=``; left unset they run on ``cuda``
and raise when there is no card.  Nothing moves to the CPU by itself.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when ``torch.cuda.is_available()`` is
    False rather than falling back to the CPU.  Pass ``device="cpu"`` to run
    the plain PyTorch versions on the host (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "peanut_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)
