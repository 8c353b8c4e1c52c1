"""HTTP inference server over a checkpoint or an exported artifact.

Counterpart of ``graph_wavenet_tpu/cli/serve.py``:

- ``--checkpoint`` with ``--graph_npz``: a city-scale checkpoint; its graph
  fingerprint is verified against the graph file, the block-sparse
  supports are rebuilt under the persisted node layout, and requests speak
  original node ids;
- ``--checkpoint`` with ``--adjdata`` (and ``--adjtype``): the dense
  supports of a DCRNN-format adjacency pickle (the METR model);
- ``--checkpoint`` alone: an adaptive-only checkpoint (``n_supports`` 0,
  trained with ``--aptonly``) or a temporal-only one (trained without
  ``--gcn_bool``);
- ``--checkpoint`` with ``--graph_bank``: a diff-G (per-sample-graph)
  checkpoint and a deployment's graph bank (``serving.save_graph_bank``);
  requests name each sample's graph by ``adj_idx``, and with community
  labels and F_t in the bank ``/predict_modalities`` serves the pooled
  F/E estimates. A diff-G checkpoint without a bank is refused;
- ``--artifact``: a ``gwt-torch-export`` artifact, weights and supports
  (or a diff-G bank) baked in, served without the model code; every
  device call is padded to the artifact's batch. Its inputs are
  standardized with ``--scaler_mean``/``--scaler_std`` (default 0 and 1).

Requests are coalesced by :class:`train.serving.MicroBatcher`. Inputs are
raw readings; feature 0 is standardized with the checkpoint's scaler on the
server and predictions return in raw units.

    python -m graph_wavenet_tpu_torch.cli.serve --checkpoint city.pt \\
        --graph_npz city_graph.npz [--device cuda] [--port 8973]
    python -m graph_wavenet_tpu_torch.cli.serve --artifact city.pt2 \\
        --scaler_mean 54.4 --scaler_std 19.5

Endpoints (JSON):
- ``GET  /healthz`` -> {"status": "ok", "source", "device", ...model info}
- ``GET  /stats``   -> request and batch counters of the micro-batcher,
  and ``queue_wait_ms`` and ``call_ms``: {"p50", "p95", "count"} of the
  requests' waits in its queue and of its calls, over the spans kept in
  ``train.profiling``'s ring (the process's last 65,536 spans)
- ``POST /predict`` body {"x": <(K, N, F) or (B, K, N, F) nested lists>}
  -> {"y": <(H, N) or (B, H, N)>}; a diff-G model also needs {"adj_idx":
  <an int, or a list of length B>}, and every instance goes to the batcher
  as ``(x, adj_idx)``, so requests for different graphs share a device
  call
- ``POST /predict_modalities`` (diff-G, a bank with labels and F_t) ->
  {"pred_F": ..., "pred_E": ...}
"""

from __future__ import annotations

import argparse
import json
import threading

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
                   help="graph bank (.npz of raw adjacencies, optional "
                        "community labels and F_t) of a diff-G checkpoint; "
                        "requests then carry 'adj_idx'")
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
    """The forecaster of ``args.checkpoint`` under the mode its flags pick,
    on ``args.device``: a :class:`train.serving.DiffGForecaster` bound to
    ``--graph_bank`` for a diff-G checkpoint, else a ``Forecaster``
    (``--graph_npz``, ``--adjdata``, or neither). Shared with
    ``gwt-torch-export``."""
    import torch

    from graph_wavenet_tpu_torch.train import checkpoint as ckpt
    from graph_wavenet_tpu_torch.train import serving

    meta = ckpt.load_metadata(args.checkpoint)
    diff_g = bool((meta.get("extra") or {}).get("diff_g"))
    if args.graph_bank:
        if not diff_g:
            raise SystemExit(
                f"--graph_bank serves diff-G (per-sample-graph) "
                f"checkpoints; {args.checkpoint} is a shared-graph one")
        fc = serving.DiffGForecaster.from_checkpoint(args.checkpoint,
                                                     device=args.device)
        return fc.bind_bank(serving.load_graph_bank(args.graph_bank),
                            adjtype=args.adjtype)
    if diff_g:
        raise SystemExit(
            f"{args.checkpoint} is a diff-G (per-sample-graph) checkpoint "
            "— pass --graph_bank <bank.npz> (serving.save_graph_bank) so "
            "requests can name their graph")
    if args.graph_npz:
        return serving.Forecaster.from_city_checkpoint(
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
    return serving.Forecaster.from_checkpoint(args.checkpoint, supports,
                                              device=args.device)


def _predictor(args):
    """-> (predict_batch, scaler, info, fixed_batch, forecaster or None,
    modalities_fn or None)."""
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train import serving

    if args.artifact:
        if args.graph_bank:
            raise SystemExit("--graph_bank applies to --checkpoint; a diff-G "
                             "artifact holds its bank")
        art = serving.load_exported_forecaster(args.artifact)
        scaler = StandardScaler(
            0.0 if args.scaler_mean is None else args.scaler_mean,
            1.0 if args.scaler_std is None else args.scaler_std)
        info = {"source": "artifact", "device": str(art.device),
                "in_shape": list(art.in_shape),
                "diff_g": art.n_graphs is not None}
        if art.n_graphs is not None:
            info["n_graphs"] = art.n_graphs
        # an artifact bakes one batch: every device call is padded to it
        return art.predict, scaler, info, int(art.in_shape[0]), None, None
    fc = load_forecaster(args)
    if isinstance(fc, serving.DiffGForecaster):
        info = {"source": "checkpoint", "device": str(fc.device),
                "diff_g": True, "num_nodes": fc.cfg.num_nodes,
                "in_dim": fc.cfg.in_dim, "n_graphs": fc.n_graphs,
                "seq_length": fc.cfg.out_dim,
                "modalities": fc.proj_stack is not None}
        modalities = (fc.predict_modalities_indexed
                      if fc.proj_stack is not None else None)
        return fc.predict_indexed, fc.scaler, info, None, fc, modalities
    info = {"source": "checkpoint", "device": str(fc.device),
            "num_nodes": fc.input_nodes, "model_nodes": fc.cfg.num_nodes,
            "in_dim": fc.cfg.in_dim, "horizon": fc.cfg.out_dim,
            "receptive_field": fc.cfg.receptive_field,
            "supports": ("none" if fc.supports is None
                         else len(fc.supports))}
    if fc.node_layout is not None:
        info.update(graph_fingerprint=fc.node_layout["fingerprint"],
                    ordering=fc.node_layout["ordering"])
    return fc.predict, fc.scaler, info, None, fc, None


def span_ms(name: str) -> dict:
    """Median, 95th percentile (ms) and count of the spans ``name`` in
    ``train.profiling``'s ring; None for both where there is none."""
    import numpy as np

    from graph_wavenet_tpu_torch.train import profiling

    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in profiling.spans()
          if s["name"] == name]
    if not ms:
        return {"p50": None, "p95": None, "count": 0}
    p50, p95 = np.percentile(ms, (50, 95)).tolist()
    return {"p50": p50, "p95": p95, "count": len(ms)}


def make_server(predict_batch, scaler, info: dict, host: str, port: int,
                max_batch: int, window_ms: float,
                fixed_batch: int | None = None, modalities_fn=None):
    """Build (ThreadingHTTPServer, MicroBatcher); the caller runs and
    closes both. ``info["diff_g"]``: requests carry ``adj_idx``;
    ``modalities_fn(x, adj_idx)`` serves ``/predict_modalities``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from graph_wavenet_tpu_torch.train.serving import MicroBatcher

    diff_g = bool(info.get("diff_g"))
    batcher = MicroBatcher(predict_batch, max_batch=max_batch,
                           window_ms=window_ms, fixed_batch=fixed_batch)

    def parse_adj_idx(req, batch: int) -> np.ndarray:
        if "adj_idx" not in req:
            raise ValueError(
                "diff-G serving requires 'adj_idx' in the request (the "
                "bank graph id per sample: an int, or a list of length "
                "B)")
        idx = np.asarray(req["adj_idx"], dtype=np.int32)
        if idx.ndim == 0:
            idx = np.full((batch,), int(idx), np.int32)
        if idx.shape != (batch,):
            raise ValueError(
                f"adj_idx must be scalar or length {batch}, got shape "
                f"{idx.shape}")
        n_graphs = info.get("n_graphs")
        if n_graphs and ((idx < 0).any() or (idx >= n_graphs).any()):
            raise ValueError(
                f"adj_idx out of range for a bank of {n_graphs} graphs")
        return idx

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
                self._json(200, {**batcher.stats,
                                 "queue_wait_ms": span_ms("serve.queued"),
                                 "call_ms": span_ms("serve.call")})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _read_x(self, req):
            x = np.asarray(req["x"], dtype=np.float32)
            if x.ndim not in (3, 4):
                raise ValueError(
                    f"x must be (K, N, F) or (B, K, N, F), got shape "
                    f"{x.shape}")
            squeeze = x.ndim == 3
            if squeeze:
                x = x[None]
            x[..., 0] = scaler.transform(x[..., 0])
            return x, squeeze

        def _modalities(self, req):
            x, squeeze = self._read_x(req)
            f, e = modalities_fn(x, parse_adj_idx(req, x.shape[0]))
            f, e = f.cpu().numpy(), e.cpu().numpy()
            if squeeze:
                f, e = f[0], e[0]
            return {"pred_F": f.tolist(), "pred_E": e.tolist()}

        def _predict(self, req):
            x, squeeze = self._read_x(req)
            # instances go through the batcher one by one, so
            # concurrent requests share device calls
            if diff_g:
                idx = parse_adj_idx(req, x.shape[0])
                ys = [batcher.submit((xi, ii)) for xi, ii in zip(x, idx)]
            else:
                ys = [batcher.submit(xi) for xi in x]
            y = np.stack(ys)
            return {"y": (y[0] if squeeze else y).tolist()}

        def do_POST(self):
            if self.path == "/predict_modalities":
                if modalities_fn is None:
                    self._json(404, {
                        "error": "modalities unavailable: serve a diff-G "
                                 "checkpoint with community labels + F_t "
                                 "in the graph bank"})
                    return
                route = self._modalities
            elif self.path == "/predict":
                route = self._predict
            else:
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                self._json(200, route(json.loads(self.rfile.read(length))))
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
    predict, scaler, info, fixed_batch, fc, modalities = _predictor(args)
    server, batcher = make_server(predict, scaler, info, args.host,
                                  args.port, args.max_batch, args.window_ms,
                                  fixed_batch, modalities_fn=modalities)
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
