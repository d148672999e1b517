"""Model export CLI (port of ``peanut_tpu.cli.export``; the reference's
deployment exporters prediction/tools/pytorch2onnx.py,
pytorch2torchscript.py, onnx2tensorrt.py): serialize a zoo segmentor's
inference program to a portable artifact.

Where the JAX package serializes a StableHLO module (``jax.export``), the
port writes a ``torch.export`` program (``.pt2``): the graph of the
model's ``inference`` on one float32 NHWC input of a static shape, with
its weights, loadable in any process with ``torch.export.load(path)
.module()``.  As in the JAX package the shape is static: the program
serves that shape alone.  The eikonal and ROI kernels of ``kernels/`` are
not ``torch.library`` ops, and no exported model calls them: the zoo's
segmentors and PEANUT's PSPNet run on torch's own operators.

Usage:
  python -m peanut_tpu_torch.cli.export CONFIG OUT.pt2
      [--checkpoint ckpt.pth] [--shape 1 720 720 14] [--verify]
      [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


class InferenceProgram(torch.nn.Module):
    """A segmentor's ``inference`` (NHWC in, NHWC logits out) as the
    ``forward`` that ``torch.export`` traces."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.inference(x)


def export_segmentor(config_path: str, out_path: str, shape,
                     checkpoint=None, verify: bool = False,
                     device=None) -> str:
    """Export the segmentor of ``config_path`` (weights from
    ``checkpoint``, else random from seed 0, as ``apis.init_segmentor``
    gives them) on ``device`` (the card unless told otherwise) for a
    float32 input of ``shape`` (N, H, W, C) to ``out_path``.  ``verify``
    reloads the artifact and holds it against the eager model on
    ``np.random.RandomState(0).rand(*shape)`` at rtol = atol = 1e-5, the
    JAX package's bar; AssertionError if it differs."""
    from .. import resolve_device
    from ..apis import init_segmentor

    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    bundle = init_segmentor(config_path, checkpoint=checkpoint,
                            input_size=shape[1], device=device)
    program = InferenceProgram(bundle.model).eval()
    with torch.no_grad():
        exported = torch.export.export(
            program, (torch.zeros(shape, dtype=torch.float32,
                                  device=device),))
    torch.export.save(exported, out_path)

    if verify:
        x = torch.as_tensor(np.random.RandomState(0).rand(*shape)
                            .astype(np.float32), device=device)
        reloaded = torch.export.load(out_path).module()
        with torch.no_grad():
            got, want = reloaded(x), bundle.model.inference(x)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    return out_path


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("out")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--shape", type=int, nargs="+",
                   default=[1, 720, 720, 14])
    p.add_argument("--verify", action="store_true",
                   help="round-trip the artifact and compare outputs")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    path = export_segmentor(args.config, args.out, args.shape,
                            checkpoint=args.checkpoint, verify=args.verify,
                            device=device or args.device)
    print(f"exported: {path}")


if __name__ == "__main__":
    main()
