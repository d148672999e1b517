"""HTTP segmentation server (port of ``peanut_tpu.cli.serve``; the
torchserve counterpart of the reference's prediction/tools/torchserve/
{mmseg2torchserve,mmseg_handler}.py): a stdlib HTTP server in front of a
zoo segmentor on the card.

  python -m peanut_tpu_torch.cli.serve CONFIG [--checkpoint CKPT]
      [--port 8080] [--host 127.0.0.1] [--device cuda]

Protocol (mmseg_handler parity):
  POST /predictions/<anything>  body = image bytes (png/jpg) or an .npy
    array -> JSON {"shape": [H, W], "classes": [[...]]} (the argmax map)
  POST /probs   -> the (C, H, W) probability map as float32 .npy bytes
  GET  /ping    -> {"status": "Healthy"}
A request that fails answers 500 with {"error": ...}.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _decode_image(body: bytes):
    if body[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(body))
    import cv2

    arr = np.frombuffer(body, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("undecodable image payload")
    return img[:, :, ::-1]  # BGR -> RGB


def make_handler(bundle):
    """The request handler class serving ``bundle`` (an
    ``apis.SegmentorBundle``), for ``ThreadingHTTPServer``."""
    from ..apis import inference_segmentor

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path.startswith("/ping"):
                self._send(200, json.dumps({"status": "Healthy"}).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = _decode_image(self.rfile.read(n))
                probs = inference_segmentor(bundle, img)     # (C, H, W)
                if self.path.startswith("/probs"):
                    buf = io.BytesIO()
                    np.save(buf, np.asarray(probs, np.float32))
                    self._send(200, buf.getvalue(),
                               "application/octet-stream")
                else:
                    pred = np.argmax(probs, axis=0).astype(np.int32)
                    self._send(200, json.dumps(
                        {"shape": list(pred.shape),
                         "classes": pred.tolist()}).encode())
            except Exception as e:  # noqa: BLE001 — serving surface
                self._send(500, json.dumps({"error": str(e)}).encode())

        def log_message(self, *a):  # quiet
            ...

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ns = ap.parse_args(argv)

    from ..apis import init_segmentor

    bundle = init_segmentor(ns.config, checkpoint=ns.checkpoint,
                            device=ns.device)
    server = ThreadingHTTPServer((ns.host, ns.port), make_handler(bundle))
    print(f"serving on http://{ns.host}:{ns.port}  (POST /predictions/x, "
          f"/probs; GET /ping)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
