"""Minimal UQ inference server (counterpart of ``examples/serving/serve.py``).

Serves a trained model bundle over HTTP through the port's bucketed
:class:`~nnueehcs_tpu_torch.serving.Predictor`, on the card unless
``--device cpu`` is given::

    python -m nnueehcs_tpu_torch.examples.serving.serve \\
        --model results/.../model.pth --port 8080 [--device cpu]

    POST /predict   {"inputs": [[...], ...]}
      -> {"predictions": [...], "uncertainty": [...], "latency_ms": ...}
    GET  /healthz   -> {"status": "ok", "uq_method": "...", ...}

A body that is not a JSON object with an ``inputs`` key of shape ``(n,
num_features)`` gets 400, an unknown path 404.
"""
from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ...serving import Predictor


def make_handler(predictor: Predictor):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._send(200, {
                    'status': 'ok',
                    'uq_method': predictor.model.uq_method,
                    'num_features': predictor.num_features,
                    'buckets': list(predictor.buckets),
                })
            else:
                self._send(404, {'error': 'unknown path'})

        def do_POST(self):
            if self.path != '/predict':
                self._send(404, {'error': 'unknown path'})
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(length))
                if not isinstance(payload, dict):
                    self._send(400, {'error': 'body must be a JSON object '
                                              'with an "inputs" key'})
                    return
                x = np.asarray(payload['inputs'], np.float32)
                if x.ndim != 2 or x.shape[1] != predictor.num_features:
                    self._send(400, {
                        'error': f'inputs must be (n, '
                                 f'{predictor.num_features})',
                        'got': list(x.shape)})
                    return
                start = time.perf_counter()
                out = predictor.predict(x)
                latency = (time.perf_counter() - start) * 1e3
                if isinstance(out, tuple):
                    pred, ue = out
                    self._send(200, {
                        'predictions': np.asarray(pred).ravel().tolist(),
                        'uncertainty': np.asarray(ue).ravel().tolist(),
                        'latency_ms': round(latency, 3)})
                else:
                    self._send(200, {
                        'predictions': np.asarray(out).ravel().tolist(),
                        'latency_ms': round(latency, 3)})
            except (KeyError, ValueError, TypeError) as e:
                # json.JSONDecodeError is a ValueError
                self._send(400, {'error': str(e)})

        def log_message(self, fmt, *args):
            pass

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description='Serve a model.pth bundle '
                                                 'over HTTP.')
    parser.add_argument('--model', dest='model_path', required=True,
                        help='Path to a model.pth bundle')
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', default=8080, type=int)
    parser.add_argument('--buckets', default='256,1024,4096',
                        help='Comma-separated batch buckets')
    parser.add_argument('--device', default='cuda',
                        help="'cpu' to serve on the CPU; default: the card")
    args = parser.parse_args(argv)
    bucket_list = [int(b) for b in args.buckets.split(',')]
    print(f'Loading {args.model_path} and warming buckets {bucket_list} '
          f'on {args.device} ...')
    predictor = Predictor(args.model_path, buckets=bucket_list,
                          device=args.device)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(predictor))
    print(f'Serving {predictor.model.uq_method} UQ model on '
          f'http://{args.host}:{args.port}')
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
