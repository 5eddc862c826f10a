"""HTTP serving entry point of the PyTorch port, over `serving.BatchingExecutor`.

    python -m invertible_cd_tpu_torch.cli.serve --model sd15 --batch_sizes 1,4 --port 8000
    curl -d '{"prompt": "a corgi", "seed": 7}' localhost:8000/generate > out.png

POST /generate  body: JSON {"prompt": str, "seed": int?}
                response: image/png (the generated image); 400 on a
                malformed body or seed, 500 when the request fails
GET  /healthz   -> {"status": "ok", ...executor stats}

Counterpart of `cli/serve.py`. Stdlib only (ThreadingHTTPServer):
concurrent client requests block on their own futures while the executor
coalesces them into batches; the PNG comes from `utils.images.encode_png`.
The bundle is `cli.generate.build_pipeline`'s, on `--device` (default
cuda), in the int8 mode of `--quantize` (as `cli.generate`; a bundle
passed to `make_server` is set to it too). Serving over several cards
(`--dp`, `--sp`) is not ported yet.

    python -m invertible_cd_tpu_torch.cli.serve --model tiny --device cpu --quantize int8 --port 8765
"""
from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .generate import add_grid_args, add_quantize_arg, add_weights_args, build_pipeline, set_quantize
from ..pipelines.pipeline import to_uint8
from ..serving import BatchingExecutor
from ..utils.images import encode_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="sd15", choices=["sd15", "sdxl", "tiny"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--batch_sizes", default=None,
                   help="comma-separated batch sizes, e.g. '1,8': each batch runs at the "
                        "smallest size that fits (a lone request skips the padding)")
    p.add_argument("--max_delay_ms", type=float, default=10.0)
    p.add_argument("--guidance_scale", type=float, default=19.0)
    p.add_argument("--tau1", type=float, default=0.8)
    p.add_argument("--tau2", type=float, default=0.8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_grid_args(p)
    add_quantize_arg(p)
    add_weights_args(p)
    return p.parse_args(argv)


def make_server(args, pipe=None):
    """Build (ThreadingHTTPServer, BatchingExecutor); callers own both (the
    server's `shutdown` and `server_close`, the executor's `shutdown`).
    `pipe` replaces the bundle the flags would build; either serves in
    `--quantize`'s mode."""
    if pipe is None:
        pipe = build_pipeline(args)
    set_quantize(pipe, args.quantize)
    g = pipe.default_guidance(guidance_scale=args.guidance_scale, dynamic_guidance=True,
                              tau1=args.tau1, tau2=args.tau2)
    sizes = tuple(int(b) for b in args.batch_sizes.split(",")) if args.batch_sizes else None
    executor = BatchingExecutor(pipe, batch_size=args.batch_size, batch_sizes=sizes,
                                max_delay=args.max_delay_ms / 1e3, guidance=g)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _reply(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, e: Exception):
            self._reply(code, json.dumps({"error": str(e)}).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"status": "ok", **executor.stats()})
                self._reply(200, body.encode(), "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict) or not isinstance(req.get("prompt"), str):
                    raise ValueError('body must be a JSON object with a string "prompt"')
                seed = req.get("seed")
                if seed is not None and not isinstance(seed, int):
                    raise ValueError('"seed" must be an integer')
                fut = executor.submit(req["prompt"], seed=seed)  # ValueError: seed outside int64
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                self._error(400, e)
                return
            try:
                img = fut.result(timeout=600)
            except Exception as e:  # noqa: BLE001 — the request failed: a 500
                self._error(500, e)
                return
            self._reply(200, encode_png(to_uint8(img)), "image/png")

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    server.executor = executor
    return server, executor


def main(argv=None):
    args = parse_args(argv)
    server, executor = make_server(args)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(batch sizes {executor.batch_sizes})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        executor.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
