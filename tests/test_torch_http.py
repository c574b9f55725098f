"""The port's HTTP front-end (rapidsnark_tpu_torch/server/http.py and
__main__.py) on the CPU: routes, both request framings with the 128 MB
cap, and the entry point's usage contract, as tests/test_server.py holds
them for the JAX package."""

import json
import threading
import time
import urllib.request

import pytest
import torch

from rapidsnark_tpu_torch.server.fullprover import FullProver

from test_torch_server import ZKEY, _fake_witness_gen, _wait_done

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _raw_http(host, port, payload: bytes) -> bytes:
    import socket

    with socket.create_connection((host, port), timeout=10) as s:
        s.sendall(payload)
        s.settimeout(10)
        out = b""
        while b"\r\n\r\n" not in out:
            chunk = s.recv(4096)
            if not chunk:
                break
            out += chunk
        return out


def test_http_chunked_body_works_and_cap_enforced(tmp_path):
    """Transfer-Encoding: chunked bodies are decoded and the 128 MB cap
    applies to them too (reference cap: main_proofserver.cpp:32; a
    Content-Length-only check would miss chunked framing entirely)."""
    from rapidsnark_tpu_torch.server.http import make_server

    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4, witness_generator=_fake_witness_gen())
    server = make_server(fp, 0, host="127.0.0.1")
    host, port = server.server_address[:2]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        body = json.dumps({"a": 3, "b": 7}).encode()
        half = len(body) // 2
        req = (b"POST /input/multiplier HTTP/1.1\r\n"
               b"Host: t\r\nTransfer-Encoding: chunked\r\n\r\n"
               + hex(half)[2:].encode() + b"\r\n" + body[:half] + b"\r\n"
               + hex(len(body) - half)[2:].encode() + b"\r\n"
               + body[half:] + b"\r\n0\r\n\r\n")
        resp = _raw_http(host, port, req)
        assert resp.startswith(b"HTTP/1.1 200")
        st = _wait_done(fp)
        assert st["status"] == "success"
        assert json.loads(st["pubData"]) == ["21"]

        # an over-cap chunk header is rejected before any data is read
        big = (b"POST /input/multiplier HTTP/1.1\r\n"
               b"Host: t\r\nTransfer-Encoding: chunked\r\n\r\n"
               b"10000000\r\n")  # one 256 MB chunk claimed
        resp = _raw_http(host, port, big)
        assert resp.startswith(b"HTTP/1.1 413")
    finally:
        server.shutdown()


def test_http_chunked_trailers_consumed(tmp_path):
    """A chunked body with trailer headers parses and the connection
    stays in sync for a follow-up request on the same socket."""
    import socket

    from rapidsnark_tpu_torch.server.http import make_server

    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4, witness_generator=_fake_witness_gen())
    server = make_server(fp, 0, host="127.0.0.1")
    host, port = server.server_address[:2]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        body = json.dumps({"a": 6, "b": 7}).encode()
        req = (b"POST /input/multiplier HTTP/1.1\r\n"
               b"Host: t\r\nTransfer-Encoding: chunked\r\n"
               b"Trailer: X-Checksum\r\n\r\n"
               + hex(len(body))[2:].encode() + b"\r\n" + body + b"\r\n"
               b"0\r\nX-Checksum: abc\r\nX-Other: d\r\n\r\n")
        with socket.create_connection((host, port), timeout=10) as s:
            s.sendall(req)
            s.settimeout(10)
            out = b""
            while b"\r\n\r\n" not in out:
                chunk = s.recv(4096)
                if not chunk:
                    break
                out += chunk
            assert out.startswith(b"HTTP/1.1 200")
            # same socket, second request: desyncs if trailers weren't
            # consumed (they'd be parsed as this request line)
            s.sendall(b"GET /status HTTP/1.1\r\nHost: t\r\n\r\n")
            out2 = b""
            while b"\r\n\r\n" not in out2:
                chunk = s.recv(4096)
                if not chunk:
                    break
                out2 += chunk
            assert out2.startswith(b"HTTP/1.1 200")
        st = _wait_done(fp)
        assert st["status"] == "success"
        assert json.loads(st["pubData"]) == ["42"]
    finally:
        server.shutdown()


def test_http_routes(tmp_path):
    from rapidsnark_tpu_torch.server.http import make_server

    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4, witness_generator=_fake_witness_gen())
    server = make_server(fp, 0, host="127.0.0.1")
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read()

        def post(path, body=b""):
            req = urllib.request.Request(base + path, data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.read()

        st, body = get("/status")
        assert st == 200 and json.loads(body) == {"status": "ready"}
        assert post("/start")[0] == 200        # stub routes
        assert post("/stop")[0] == 200
        assert post("/cancel")[0] == 200
        st, _ = post("/input/multiplier",
                     json.dumps({"a": 2, "b": 4}).encode())
        assert st == 200
        t0 = time.time()
        while time.time() - t0 < 900:
            st, body = get("/status")
            if json.loads(body)["status"] != "busy":
                break
            time.sleep(0.05)
        payload = json.loads(body)
        assert payload["status"] == "success"
        assert json.loads(payload["pubData"]) == ["8"]
        # unknown circuit -> 404
        with pytest.raises(urllib.error.HTTPError):
            post("/input/nonexistent", b"{}")
    finally:
        server.shutdown()


def test_entry_point_usage_and_no_card(capsys):
    """Fewer than two arguments: the reference's usage text and 255. With
    arguments and no card the entry point raises (it never serves from
    the CPU)."""
    from rapidsnark_tpu_torch.server.__main__ import main
    assert main([]) == 255 and main(["9080"]) == 255
    err = capsys.readouterr().err
    assert "Usage: proverServer <port> <circuit1.zkey>" in err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["0", ZKEY])
