"""HTTP inference server over a city-scale checkpoint.

Counterpart of ``graph_wavenet_tpu/cli/serve.py``'s checkpoint +
``--graph_npz`` mode: the checkpoint's graph fingerprint is verified
against the graph file, the block-sparse supports are rebuilt under the
persisted node layout, and requests speak original node ids. Requests are
coalesced by :class:`train.serving.MicroBatcher`. Inputs are raw readings;
feature 0 is standardized with the checkpoint's scaler on the server and
predictions return in raw units.

    python -m graph_wavenet_tpu_torch.cli.serve --checkpoint city.pt \\
        --graph_npz city_graph.npz [--device cuda] [--port 8973]

Endpoints (JSON):
- ``GET  /healthz`` -> {"status": "ok", ...model info}
- ``GET  /stats``   -> request and batch counters of the micro-batcher
- ``POST /predict`` body {"x": <(K, N, F) or (B, K, N, F) nested lists>}
  -> {"y": <(H, N) or (B, H, N)>}
"""

from __future__ import annotations

import argparse
import json
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-serve", description="Serve forecasts of a city-scale "
        "checkpoint over HTTP with dynamic request batching")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="port checkpoint (torch.save state dict with its "
                        ".json sidecar)")
    p.add_argument("--graph_npz", type=str, required=True,
                   help="edge-list graph the checkpoint was trained on "
                        "(fingerprint-verified)")
    p.add_argument("--aptonly", action="store_true",
                   help="accepted for the reference CLI's sake; a checkpoint "
                        "trained with --aptonly (n_supports 0) is served with "
                        "the learned adjacency alone either way")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default cuda)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8973)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--window_ms", type=float, default=2.0,
                   help="how long the batcher waits to coalesce concurrent "
                        "requests")
    return p


def make_server(predict_batch, scaler, info: dict, host: str, port: int,
                max_batch: int, window_ms: float):
    """Build (ThreadingHTTPServer, MicroBatcher); the caller runs and
    closes both."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from graph_wavenet_tpu_torch.train.serving import MicroBatcher

    batcher = MicroBatcher(predict_batch, max_batch=max_batch,
                           window_ms=window_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):          # quiet; /stats has the numbers
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **info})
            elif self.path == "/stats":
                self._json(200, batcher.stats)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                x = np.asarray(req["x"], dtype=np.float32)
                if x.ndim not in (3, 4):
                    raise ValueError(
                        f"x must be (K, N, F) or (B, K, N, F), got shape "
                        f"{x.shape}")
                squeeze = x.ndim == 3
                if squeeze:
                    x = x[None]
                x[..., 0] = scaler.transform(x[..., 0])
                # instances go through the batcher one by one, so
                # concurrent requests share device calls
                y = np.stack([batcher.submit(xi) for xi in x])
                self._json(200, {"y": (y[0] if squeeze else y).tolist()})
            except Exception as e:          # surface the cause to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    return server, batcher


def main(argv=None, serve_forever: bool = True):
    """Run the server. With ``serve_forever=False`` it serves on a daemon
    thread and returns {"server", "batcher", "thread", "forecaster"}; the
    caller shuts the server down and stops the batcher."""
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    args = build_parser().parse_args(argv)
    fc = Forecaster.from_city_checkpoint(args.checkpoint, args.graph_npz,
                                         device=args.device)
    info = {"source": "checkpoint", "device": str(fc.device),
            "num_nodes": fc.input_nodes, "model_nodes": fc.cfg.num_nodes,
            "graph_fingerprint": fc.node_layout["fingerprint"],
            "ordering": fc.node_layout["ordering"],
            "in_dim": fc.cfg.in_dim, "horizon": fc.cfg.out_dim,
            "receptive_field": fc.cfg.receptive_field}
    server, batcher = make_server(fc.predict, fc.scaler, info, args.host,
                                  args.port, args.max_batch, args.window_ms)
    print(f"gwt-torch-serve: {info} on "
          f"http://{args.host}:{server.server_port}", flush=True)
    if serve_forever:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            batcher.stop()
            server.server_close()
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return {"server": server, "batcher": batcher, "thread": thread,
            "forecaster": fc}


def cli() -> None:
    main()


if __name__ == "__main__":
    main()
