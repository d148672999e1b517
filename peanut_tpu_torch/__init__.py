"""peanut_tpu_torch — the PyTorch/CUDA port of peanut_tpu for one NVIDIA H100.

The JAX package ``peanut_tpu`` stays the reference.  This package mirrors its
layout module for module, imports ``torch`` and numpy and never JAX nor any
module of ``peanut_tpu``, and replaces each Pallas TPU kernel on its path with
a CUDA C++ kernel built for ``sm_90a`` at first use (``kernels/csrc``).

Layering (bottom-up), as in the JAX package:
  geometry/   camera + pose math
  kernels/    splat, grid-sample warp, morphology (torch built-ins), the
              eikonal solver, whose three TPU kernels are CUDA kernels
              here, ROIAlign window pooling and NMS (CUDA kernels)
  models/     Mask R-CNN R101-FPN and PSPNet-R50-v1c (train mode too),
              the segmentation losses, the model zoo's ResNet
              (ResNet, ResNetV1c, ResNeXt), transformer (ViT, Swin, MiT,
              ConvNeXt, Twins, BEiT, MAE), cascade (K-Net, PointRend) and
              light-CNN (HRNet, UNet, MobileNetV2/V3, ResNeSt, BiSeNet,
              STDC, ICNet, Fast-SCNN, CGNet, ERFNet) families (heads,
              necks, the registry-driven builder)
  mapping/    per-step semantic map update
  perception/ depth preprocessing, ground-truth and Mask R-CNN segmenters
  prediction/ the target-prediction model; its training: map dataset and
              augmentations (native/map_pipeline.cc through ctypes), the
              train step, the iteration runner, evaluation metrics
  planning/   FMM planner host code, untrap state machine
  agent/      the single-env agent; batched ops + the batched
              parallel-episode runtime
  envs/       synthetic environments, the habitat adapter, the batch runner
  core/       training checkpoints, the zoo's config-file loader
  utils/      stage timer, drawing, the episode dashboard, logger hooks
  cli/        collect, collect_maps, eval, train_prediction_model, test,
              serve and benchmark (the zoo's)
  registry.py, apis.py   the zoo's registries and mmseg-style API

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


def upload(x, device, dtype=None) -> torch.Tensor:
    """Host data (numpy, a list, a CPU tensor) as a tensor on ``device``.

    To a card it goes through pinned memory without blocking: a copy from
    pageable memory waits for the stream to drain, which would hold the
    caller (an env-step thread launching a detect chunk, say) until every
    queued kernel has finished."""
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
