"""HTTP front-end for the proof service.

Counterpart of `rapidsnark_tpu/server/http.py`. Routes mirror the
reference's src/main_proofserver.cpp:36-40 and proverapi.cpp:
    GET  /status            -> FullProver.get_status JSON
    POST /start, /stop      -> 200 OK stubs (proverapi.cpp:27-33)
    GET/POST /config        -> 200 OK stubs (proverapi.cpp:35-41)
    POST /input/:circuit    -> FullProver.start_prove(body, circuit)
    POST /cancel            -> FullProver.abort

Stdlib http.server replaces pistache. The reference endpoint runs
threads(1) with a 128 MB request cap (main_proofserver.cpp:32); here a
ThreadingHTTPServer keeps /status responsive during long proves (the
FullProver state machine is lock-guarded, so concurrent handlers are
safe) and the 128 MB body cap is enforced per request.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .fullprover import FullProver

MAX_REQUEST_SIZE = 128_000_000  # main_proofserver.cpp:32


class ProverAPIHandler(BaseHTTPRequestHandler):
    full_prover: FullProver  # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through our logger
        from ..utils.logger import get_logger
        get_logger().debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, body: bytes = b"",
              ctype: str = "application/json"):
        self.send_response(code)
        if body:
            self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_GET(self):
        if self.path == "/status":
            payload = json.dumps(self.full_prover.get_status()).encode()
            self._send(200, payload)
        elif self.path == "/config":
            self._send(200)
        else:
            self._send(404)

    def _read_body(self) -> Optional[bytes]:
        """Request body with the 128 MB cap enforced for BOTH framings:
        Content-Length and Transfer-Encoding: chunked (a chunked request
        has no Content-Length, so a length-only check would let an
        unbounded body through — reference cap: main_proofserver.cpp:32).
        Returns None after sending 413/400."""
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            parts, total = [], 0
            while True:
                line = self.rfile.readline(32)
                try:
                    size = int(line.split(b";")[0].strip() or b"0", 16)
                except ValueError:
                    self._send(400)
                    return None
                if size == 0:
                    # consume optional trailer headers up to the final
                    # empty line (RFC 9112 §7.1.2) — stopping at one
                    # readline desyncs the connection for clients that
                    # send trailers
                    while True:
                        t = self.rfile.readline(1024)
                        if t in (b"\r\n", b"\n", b""):
                            break
                    break
                total += size
                if total > MAX_REQUEST_SIZE:
                    self._send(413)
                    self.close_connection = True
                    return None
                parts.append(self.rfile.read(size))
                self.rfile.readline()  # chunk-data CRLF
            return b"".join(parts)
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length > MAX_REQUEST_SIZE:
            self._send(413)
            return None
        return self.rfile.read(length)

    def do_POST(self):
        raw = self._read_body()
        if raw is None:
            return
        body = raw.decode("utf-8", "replace")
        if self.path.startswith("/input/"):
            circuit = self.path[len("/input/"):]
            if circuit not in self.full_prover.provers:
                self._send(404, json.dumps(
                    {"error": f"unknown circuit {circuit}"}).encode())
                return
            self.full_prover.start_prove(body, circuit)
            self._send(200)
        elif self.path == "/cancel":
            self.full_prover.abort()
            self._send(200)
        elif self.path in ("/start", "/stop", "/config"):
            self._send(200)
        else:
            self._send(404)


def make_server(full_prover: FullProver, port: int,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    handler = type("BoundHandler", (ProverAPIHandler,),
                   {"full_prover": full_prover})
    return ThreadingHTTPServer((host, port), handler)


def serve(zkey_files, port: int, host: str = "0.0.0.0",
          window_bits: Optional[int] = None, build_dir: str = "./build",
          device=None):
    """Serve on `device` (None: the CUDA card; raises without one).

    Listener goes up BEFORE the zkey registry loads: a /status poll
    during a slow multi-GB init answers 200 + {} (the initializing
    status, fullprover.hpp:14) instead of connection-refused — the
    reference can't do this (pistache starts after the constructor,
    main_proofserver.cpp:30-43) and only signals init via logs."""
    import threading

    from ..utils.logger import get_logger
    log = get_logger()
    log.info("Initializing server...")
    fp = FullProver(zkey_files, build_dir=build_dir, window_bits=window_bits,
                    device=device, defer_load=True)
    server = make_server(fp, port, host)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    fp.load()
    log.info("Server ready on port %d...", port)
    th.join()
