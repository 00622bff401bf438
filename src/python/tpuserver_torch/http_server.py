"""HTTP front end of the port: the KServe-v2 health, metadata and
generate endpoints over ``http.server.ThreadingHTTPServer`` (the port of
``tpuserver/http_frontend.py``'s generation surface).

Routes::

    GET  /v2/health/live | /v2/health/ready
    GET  /metrics
    GET  /v2/models/stats
    GET  /v2/models/<m>[/versions/<v>] | .../config | .../ready | .../stats
    POST /v2/models/<m>[/versions/<v>]/generate
    POST /v2/models/<m>[/versions/<v>]/generate_stream
    GET|POST /v2/{systemsharedmemory,cudasharedmemory,xlasharedmemory}
             [/region/<name>]/{status,register,unregister}
    GET  /v2/kvexport/<generation_id>
    POST /v2/kvexport/<generation_id>/release

``/generate`` and ``/generate_stream`` take the infer JSON shape
(``inputs`` with ``name``/``datatype``/``shape``/``data``, optional
``parameters``).  ``/generate`` answers one JSON object whose outputs
carry a leading step axis; ``/generate_stream`` answers server-sent
events over chunked transfer: one ``data:`` event per response, then
``data: {"final": true}``.  A response of the continuous-batching path
carries its ``generation_id`` and ``seq`` as the event's ``parameters``
and as an ``id: <generation_id>/<seq>`` line before its ``data:`` line.
An error after the stream started arrives in-band as ``data: {"error":
...}``.  A shed request (429) is answered with a ``Retry-After`` header.
A ``/generate_stream`` request with a ``Last-Event-ID: <generation_id>/
<seq>`` header resumes that generation from ``seq + 1`` (an unknown one
answers 404 before any event).

Shared memory: an input may name a registered region instead of carrying
``data`` (``parameters``: ``shared_memory_region``,
``shared_memory_byte_size``, ``shared_memory_offset``); from a CUDA
region the model then reads a view of the region's device memory.  The
region is pinned from the read to the end of the stream.  A CUDA region
registers with ``{"raw_handle": {"b64": <base64 of the 64-byte
cudaIpcMemHandle_t>}, "device_id": 0, "byte_size": N}``, Triton's wire
format; a system region with ``{"key": "/name", "offset": 0,
"byte_size": N}``.  ``/v2/kvexport/<generation_id>`` hands out a KV
export's one-shot descriptor (404 when there is none, 409 on a second
fetch); ``.../release`` drops the export.

``/metrics`` serves the core's Prometheus exposition
(``InferenceServer.metrics_text``, the bytes the gRPC ``ServerMetrics``
unary carries).  The ``http.generate_stream`` fault point trips before
each SSE event write: ``raise`` severs the connection mid-stream, with
no terminal chunk, which drives a client's ``Last-Event-ID`` resume.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

import numpy as np

from tpuserver_torch import fault_points
from tpuserver_torch.core import InferRequest, wire_to_np_dtype
from tpuserver_torch.errors import BadRequest, ModelNotFound, TorchServeError

_MODEL_URI = re.compile(
    r"^/v2/models/(?P<model>[^/]+)(/versions/(?P<version>[^/]+))?"
    r"(?P<rest>/.*)?$"
)
_SHM_URI = re.compile(
    r"^/v2/(?P<kind>systemsharedmemory|cudasharedmemory|xlasharedmemory)"
    r"(/region/(?P<region>[^/]+))?/(?P<verb>status|register|unregister)$"
)
_KVEXPORT_URI = re.compile(
    r"^/v2/kvexport/(?P<gen>[^/]+)(?P<release>/release)?$"
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

    def _send(self, code, body=b"", content_type="application/json",
              headers=()):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, obj, code=200, headers=()):
        self._send(code, json.dumps(obj).encode("utf-8"), headers=headers)

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
            retry_after = getattr(e, "retry_after", None)
            headers = (("Retry-After", str(int(retry_after))),) \
                if retry_after is not None else ()
            self._send_json({"error": str(e)}, e.code, headers)
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
        if path == "/metrics":
            return self._send(200, core.metrics_text().encode("utf-8"),
                              content_type="text/plain; version=0.0.4")
        if path == "/v2/models/stats":
            return self._send_json(core.model_statistics())
        m = _KVEXPORT_URI.match(path)
        if m:
            gen_id = unquote(m.group("gen"))
            if m.group("release"):
                if method != "POST":
                    raise TorchServeError("kvexport release requires POST",
                                          code=405)
                core.drop_kv_region(gen_id)
                return self._send_json({})
            if method != "GET":
                raise TorchServeError("kvexport descriptor fetch requires "
                                      "GET", code=405)
            return self._send_json(core.kv_export_descriptor(gen_id))
        m = _SHM_URI.match(path)
        if m:
            return self._shm(m)
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
            if rest == "/stats" and method == "GET":
                return self._send_json(core.model_statistics(model, version))
            if rest in ("/generate", "/generate_stream") and method == "POST":
                return self._generate(model, version,
                                      stream=rest == "/generate_stream")
        raise ModelNotFound("unknown endpoint: {} {}".format(method, path))

    def _shm(self, m):
        core = self.server.core
        kind = m.group("kind")
        region = unquote(m.group("region")) if m.group("region") else ""
        verb = m.group("verb")
        if verb == "status":
            status = {"systemsharedmemory": core.system_shm_status,
                      "cudasharedmemory": core.cuda_shm_status,
                      "xlasharedmemory": core.xla_shm_status}[kind]
            return self._send_json(status(region))
        if verb == "unregister":
            {"systemsharedmemory": core.unregister_system_shm,
             "cudasharedmemory": core.unregister_cuda_shm,
             "xlasharedmemory": core.unregister_xla_shm}[kind](region)
            return self._send_json({})
        req = self._read_json()
        try:
            if kind == "systemsharedmemory":
                core.register_system_shm(region, req["key"],
                                         req.get("offset", 0),
                                         req["byte_size"])
            elif kind == "cudasharedmemory":
                core.register_cuda_shm(
                    region, (req.get("raw_handle") or {}).get("b64", ""),
                    req.get("device_id", 0), req["byte_size"])
            else:
                core.register_xla_shm(
                    region, (req.get("raw_handle") or {}).get("b64", ""),
                    req.get("device_ordinal", 0), req["byte_size"])
        except KeyError as e:
            raise BadRequest("shared memory register request lacks "
                             "{}".format(e))
        return self._send_json({})

    def _generate(self, model, version, stream):
        pinned = []
        try:
            self._generate_pinned(model, version, stream, pinned)
        finally:
            for name in pinned:
                self.server.core.unpin_shm_region(name)

    def _generate_pinned(self, model, version, stream, pinned):
        """``_generate``'s body; ``pinned`` collects the regions it pinned
        (from the read of a shm input to the end of the stream, so an
        unregister cannot close the memory a view reads)."""
        core = self.server.core
        body = self._read_json()
        inputs = {}
        for tin in body.get("inputs", []):
            tparams = tin.get("parameters") or {}
            region = tparams.get("shared_memory_region")
            if region is None:
                inputs[tin.get("name")] = _array_from_json(tin)
                continue
            if not tin.get("datatype") or "shape" not in tin:
                raise BadRequest("generate input '{}' needs a datatype and "
                                 "a shape".format(tin.get("name")))
            core.pin_shm_region(region)
            pinned.append(region)
            inputs[tin.get("name")] = core.read_shm_input(
                region, tparams.get("shared_memory_byte_size", 0),
                tparams.get("shared_memory_offset", 0), tin["datatype"],
                tin["shape"])
        parameters = dict(body.get("parameters", {}))
        last_id = self.headers.get("Last-Event-ID")
        if stream and last_id:
            # an SSE reconnect: the client re-POSTs the same body with
            # the last id it read; the generation replays from seq + 1.
            # The LAST slash splits: a client-chosen generation_id may
            # itself hold one
            gen_id, sep, seq = last_id.rpartition("/")
            if sep and gen_id:
                try:
                    parameters.setdefault("resume_from_seq", int(seq) + 1)
                    parameters.setdefault("resume_generation_id", gen_id)
                except ValueError:
                    pass  # a malformed id: a fresh request
        request = InferRequest(model, version, body.get("id", ""), inputs,
                               parameters)
        request.shm_input_regions = tuple(pinned)
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
                payload = _response_json(resp)
                event = b""
                wire = {k: v for k, v in resp.parameters.items()
                        if not k.startswith("triton_")}
                if wire:
                    payload["parameters"] = wire
                    gen_id = wire.get("generation_id")
                    seq = wire.get("seq")
                    if gen_id is not None and seq is not None:
                        event = "id: {}/{}\n".format(gen_id, seq).encode(
                            "utf-8")
                # the mid-stream disconnect point: skip=N drops the
                # connection after the Nth event
                fault_points.trip("http.generate_stream", core.fault_scope)
                self._chunk(event + b"data: " + json.dumps(payload).encode(
                    "utf-8") + b"\n\n")
        except fault_points.FaultInjected:
            try:
                self.connection.close()
            finally:
                raise BrokenPipeError("injected mid-stream disconnect")
        except TorchServeError as e:
            if not started:
                raise
            self._chunk(b"data: " + json.dumps(
                {"error": str(e)}).encode("utf-8") + b"\n\n")
            self._chunk(b"")
            return
        finally:
            # a client gone mid-stream ends its generation now (which
            # parks it for a resume), not when the frame is collected
            responses.close()
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
        self._core.attach_frontend()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
            self._core.detach_frontend()
