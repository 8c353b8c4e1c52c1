"""HTTP inference server over a checkpoint or an exported artifact.

Counterpart of ``graph_wavenet_tpu/cli/serve.py``'s shared-graph modes:

- ``--checkpoint`` with ``--graph_npz``: a city-scale checkpoint; its graph
  fingerprint is verified against the graph file, the block-sparse
  supports are rebuilt under the persisted node layout, and requests speak
  original node ids;
- ``--checkpoint`` with ``--adjdata`` (and ``--adjtype``): the dense
  supports of a DCRNN-format adjacency pickle (the METR model);
- ``--checkpoint`` alone: an adaptive-only checkpoint (``n_supports`` 0,
  trained with ``--aptonly``) or a temporal-only one (trained without
  ``--gcn_bool``);
- ``--artifact``: a ``gwt-torch-export`` artifact, weights and supports
  baked in, served without the model code; every device call is padded to
  the artifact's batch. Its inputs are standardized with
  ``--scaler_mean``/``--scaler_std`` (default 0 and 1).

Requests are coalesced by :class:`train.serving.MicroBatcher`. Inputs are
raw readings; feature 0 is standardized with the checkpoint's scaler on the
server and predictions return in raw units.

    python -m graph_wavenet_tpu_torch.cli.serve --checkpoint city.pt \\
        --graph_npz city_graph.npz [--device cuda] [--port 8973]
    python -m graph_wavenet_tpu_torch.cli.serve --artifact city.pt2 \\
        --scaler_mean 54.4 --scaler_std 19.5

Endpoints (JSON):
- ``GET  /healthz`` -> {"status": "ok", "source", "device", ...model info}
- ``GET  /stats``   -> request and batch counters of the micro-batcher
- ``POST /predict`` body {"x": <(K, N, F) or (B, K, N, F) nested lists>}
  -> {"y": <(H, N) or (B, H, N)>}
"""

from __future__ import annotations

import argparse
import json
import threading

DIFF_G = ("diff-G (per-sample-graph) checkpoints and graph banks are not "
          "ported yet (ROADMAP.md queue 1, slice 6)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-serve", description="Serve forecasts over HTTP with "
        "dynamic request batching")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", type=str,
                     help="port checkpoint (torch.save state dict with its "
                          ".json sidecar)")
    src.add_argument("--artifact", type=str,
                     help="gwt-torch-export artifact (.pt2, weights and "
                          "supports baked in)")
    p.add_argument("--graph_npz", type=str, default=None,
                   help="edge-list graph a city-scale checkpoint was "
                        "trained on (fingerprint-verified)")
    p.add_argument("--adjdata", type=str, default=None,
                   help="adjacency pickle of a dense checkpoint's fixed "
                        "supports (omit for aptonly and temporal-only "
                        "checkpoints)")
    p.add_argument("--adjtype", type=str, default="doubletransition")
    p.add_argument("--aptonly", action="store_true",
                   help="accepted for the reference CLI's sake; a checkpoint "
                        "trained with --aptonly (n_supports 0) is served with "
                        "the learned adjacency alone either way")
    p.add_argument("--graph_bank", type=str, default=None,
                   help="refused: " + DIFF_G)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve a checkpoint on (default "
                        "cuda); an artifact runs on the device it was "
                        "exported on")
    p.add_argument("--scaler_mean", type=float, default=None,
                   help="artifact mode: feature-0 standardization mean")
    p.add_argument("--scaler_std", type=float, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8973)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--window_ms", type=float, default=2.0,
                   help="how long the batcher waits to coalesce concurrent "
                        "requests")
    return p


def load_forecaster(args):
    """The Forecaster of ``args.checkpoint`` under the mode its flags pick
    (``--graph_npz``, ``--adjdata``, or neither), on ``args.device``;
    diff-G is refused. Shared with ``gwt-torch-export``."""
    import torch

    from graph_wavenet_tpu_torch.train import checkpoint as ckpt
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    if args.graph_bank:
        raise SystemExit(f"--graph_bank: {DIFF_G}")
    meta = ckpt.load_metadata(args.checkpoint)
    if (meta.get("extra") or {}).get("diff_g"):
        raise SystemExit(f"{args.checkpoint}: {DIFF_G}")
    if args.graph_npz:
        return Forecaster.from_city_checkpoint(
            args.checkpoint, args.graph_npz, device=args.device)
    cfg = meta["model_cfg"]
    if (meta.get("extra") or {}).get("graph_layout") is not None:
        raise SystemExit(f"{args.checkpoint} was trained on a city-scale "
                         "graph; pass --graph_npz with that graph")
    if cfg.gcn_bool and cfg.addaptadj and cfg.n_supports == 0:
        supports = []                   # aptonly: the learned graph alone
    elif not cfg.gcn_bool:
        supports = None                 # temporal-only
    elif args.adjdata:
        from graph_wavenet_tpu_torch.graphs.normalize import load_adj

        _, _, adj = load_adj(args.adjdata, args.adjtype)
        supports = [torch.as_tensor(a) for a in adj]
    else:
        raise SystemExit(
            f"{args.checkpoint} diffuses over {cfg.n_supports} fixed "
            "supports; pass --adjdata (and --adjtype) with its adjacency")
    return Forecaster.from_checkpoint(args.checkpoint, supports,
                                      device=args.device)


def _predictor(args):
    """-> (predict_batch, scaler, info, fixed_batch, forecaster or None)."""
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train import serving

    if args.artifact:
        if args.graph_bank:
            raise SystemExit(f"--graph_bank: {DIFF_G}")
        art = serving.load_exported_forecaster(args.artifact)
        scaler = StandardScaler(
            0.0 if args.scaler_mean is None else args.scaler_mean,
            1.0 if args.scaler_std is None else args.scaler_std)
        info = {"source": "artifact", "device": str(art.device),
                "in_shape": list(art.in_shape)}
        # an artifact bakes one batch: every device call is padded to it
        return art.predict, scaler, info, int(art.in_shape[0]), None
    fc = load_forecaster(args)
    info = {"source": "checkpoint", "device": str(fc.device),
            "num_nodes": fc.input_nodes, "model_nodes": fc.cfg.num_nodes,
            "in_dim": fc.cfg.in_dim, "horizon": fc.cfg.out_dim,
            "receptive_field": fc.cfg.receptive_field,
            "supports": ("none" if fc.supports is None
                         else len(fc.supports))}
    if fc.node_layout is not None:
        info.update(graph_fingerprint=fc.node_layout["fingerprint"],
                    ordering=fc.node_layout["ordering"])
    return fc.predict, fc.scaler, info, None, fc


def make_server(predict_batch, scaler, info: dict, host: str, port: int,
                max_batch: int, window_ms: float,
                fixed_batch: int | None = None):
    """Build (ThreadingHTTPServer, MicroBatcher); the caller runs and
    closes both."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from graph_wavenet_tpu_torch.train.serving import MicroBatcher

    batcher = MicroBatcher(predict_batch, max_batch=max_batch,
                           window_ms=window_ms, fixed_batch=fixed_batch)

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
    thread and returns {"server", "batcher", "thread", "forecaster"} (the
    forecaster None for an artifact); the caller shuts the server down and
    stops the batcher."""
    args = build_parser().parse_args(argv)
    predict, scaler, info, fixed_batch, fc = _predictor(args)
    server, batcher = make_server(predict, scaler, info, args.host,
                                  args.port, args.max_batch, args.window_ms,
                                  fixed_batch)
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
