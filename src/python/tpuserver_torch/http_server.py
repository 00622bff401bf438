"""HTTP front end of the port: the KServe-v2 health, metadata and
generate endpoints over ``http.server.ThreadingHTTPServer`` (the port of
``tpuserver/http_frontend.py``'s generation surface).

Routes::

    GET  /v2/health/live | /v2/health/ready
    GET  /v2/models/<m>[/versions/<v>] | .../config | .../ready
    POST /v2/models/<m>[/versions/<v>]/generate
    POST /v2/models/<m>[/versions/<v>]/generate_stream

``/generate`` and ``/generate_stream`` take the infer JSON shape
(``inputs`` with ``name``/``datatype``/``shape``/``data``, optional
``parameters``).  ``/generate`` answers one JSON object whose outputs
carry a leading step axis; ``/generate_stream`` answers server-sent
events over chunked transfer: one ``data:`` event per response, then
``data: {"final": true}``.  An error after the stream started arrives
in-band as ``data: {"error": ...}``.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

import numpy as np

from tpuserver_torch.core import InferRequest, wire_to_np_dtype
from tpuserver_torch.errors import BadRequest, ModelNotFound, TorchServeError

_MODEL_URI = re.compile(
    r"^/v2/models/(?P<model>[^/]+)(/versions/(?P<version>[^/]+))?"
    r"(?P<rest>/.*)?$"
)


def _array_from_json(tin):
    datatype = tin.get("datatype")
    if not datatype:
        raise BadRequest(
            "generate input '{}' needs a datatype".format(tin.get("name")))
    try:
        return np.asarray(tin.get("data"), dtype=wire_to_np_dtype(
            datatype)).reshape(tin["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise BadRequest("input '{}': {}".format(tin.get("name"), e))


def _response_json(resp):
    out = {"model_name": resp.model_name,
           "model_version": resp.model_version, "outputs": []}
    if resp.id:
        out["id"] = resp.id
    for spec, array in resp.outputs:
        entry = dict(spec)
        entry["data"] = array.reshape(-1).tolist()
        out["outputs"].append(entry)
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tpuserver-torch"

    def handle(self):
        try:
            super().handle()
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away between requests

    def log_message(self, format, *args):
        pass  # no per-request access log on the serving path

    # -- framing -------------------------------------------------------------

    def _send(self, code, body=b"", content_type="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, obj, code=200):
        self._send(code, json.dumps(obj).encode("utf-8"))

    def _read_json(self):
        n = int(self.headers.get("Content-Length") or 0)
        try:
            return json.loads(self.rfile.read(n) or b"{}")
        except ValueError as e:
            raise BadRequest("malformed request: {}".format(e))

    def _start_events(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _chunk(self, data):
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def _handle(self, method):
        try:
            self._dispatch_path(method)
        except TorchServeError as e:
            self._send_json({"error": str(e)}, e.code)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _dispatch_path(self, method):
        path = self.path.split("?", 1)[0]
        core = self.server.core
        if path == "/v2/health/live":
            return self._send(200)
        if path == "/v2/health/ready":
            return self._send(200 if core.server_ready() else 503)
        if path in ("/v2", "/v2/"):
            return self._send_json(core.server_metadata())
        m = _MODEL_URI.match(path)
        if m:
            model = unquote(m.group("model"))
            version = m.group("version") or ""
            rest = m.group("rest") or ""
            if rest == "/ready":
                return self._send(
                    200 if core.model_ready(model, version) else 400)
            if rest in ("", "/") and method == "GET":
                return self._send_json(core.model_metadata(model, version))
            if rest == "/config" and method == "GET":
                return self._send_json(core.model_config(model, version))
            if rest in ("/generate", "/generate_stream") and method == "POST":
                return self._generate(model, version,
                                      stream=rest == "/generate_stream")
        raise ModelNotFound("unknown endpoint: {} {}".format(method, path))

    def _generate(self, model, version, stream):
        core = self.server.core
        body = self._read_json()
        inputs = {tin.get("name"): _array_from_json(tin)
                  for tin in body.get("inputs", [])}
        request = InferRequest(model, version, body.get("id", ""), inputs,
                               dict(body.get("parameters", {})))
        responses = core.infer_stream(request)
        if not stream:
            merged = None
            for resp in responses:
                piece = _response_json(resp)
                if merged is None:
                    merged = piece
                    for entry in merged["outputs"]:
                        entry["shape"] = [1] + entry["shape"]
                    continue
                by_name = {e["name"]: e for e in merged["outputs"]}
                for entry in piece["outputs"]:
                    tgt = by_name[entry["name"]]
                    tgt["data"].extend(entry["data"])
                    tgt["shape"][0] += 1
            if merged is None:
                merged = {"model_name": model, "model_version": version,
                          "outputs": []}
            return self._send_json(merged)

        started = False
        try:
            for resp in responses:
                if not started:
                    self._start_events()
                    started = True
                self._chunk(b"data: " + json.dumps(
                    _response_json(resp)).encode("utf-8") + b"\n\n")
        except TorchServeError as e:
            if not started:
                raise
            self._chunk(b"data: " + json.dumps(
                {"error": str(e)}).encode("utf-8") + b"\n\n")
            self._chunk(b"")
            return
        if not started:
            self._start_events()
        self._chunk(b'data: {"final": true}\n\n')
        self._chunk(b"")


class HttpServer:
    """``ThreadingHTTPServer`` over an ``InferenceServer``: ``start()`` /
    ``stop()``; ``port`` is known once constructed (pass 0 for a free
    one)."""

    def __init__(self, core, host="127.0.0.1", port=0):
        self._core = core
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.core = core
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return "{}:{}".format(self._httpd.server_address[0], self.port)

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="tpuserver-torch-http", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
