"""HTTP front end of the port: the KServe-v2 REST protocol with the
binary-tensor extension over ``http.server.ThreadingHTTPServer`` (the
port of ``tpuserver/http_frontend.py``).

Routes::

    GET  /v2 | /v2/health/live | /v2/health/ready | /v2/health/stats
    GET  /metrics
    GET|POST /v2/logging | /v2/trace/setting
    GET  /v2/models/stats
    GET  /v2/models/<m>[/versions/<v>] | .../config | .../ready | .../stats
    GET|POST /v2/models/<m>[/versions/<v>]/trace/setting
    POST /v2/models/<m>[/versions/<v>]/infer
    POST /v2/models/<m>[/versions/<v>]/generate
    POST /v2/models/<m>[/versions/<v>]/generate_stream
    POST /v2/repository/index
    POST /v2/repository/models/<m>/{load,unload}
    GET|POST /v2/{systemsharedmemory,cudasharedmemory,xlasharedmemory}
             [/region/<name>]/{status,register,unregister}
    GET  /v2/kvexport/<generation_id>
    POST /v2/kvexport/<generation_id>/release

``/infer`` takes a JSON body, or with an ``Inference-Header-Content-
Length`` header a JSON header and then the inputs' raw bytes (each
input's ``binary_data_size`` parameter), gzip or deflate compressed when
``Content-Encoding`` says so.  An output comes back as JSON ``data``, as
raw bytes after the JSON header (its ``binary_data`` parameter, or the
request's ``binary_data_output``), as top-k ``classification`` strings,
or into a shared-memory region (``shared_memory_region``,
``shared_memory_byte_size``, ``shared_memory_offset``); the response is
gzip or deflate compressed as ``Accept-Encoding`` asks.  BYTES travel
length-prefixed, BF16 as its bits (binary only).

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
region is pinned from the read to the end of the stream (released before
the final marker goes out).  A CUDA region
registers with ``{"raw_handle": {"b64": <base64 of the 64-byte
cudaIpcMemHandle_t>}, "device_id": 0, "byte_size": N}``, Triton's wire
format; a system region with ``{"key": "/name", "offset": 0,
"byte_size": N}``.  ``/v2/kvexport/<generation_id>`` hands out a KV
export's one-shot descriptor (404 when there is none, 409 on a second
fetch); ``.../release`` drops the export.

``/v2/health/ready`` answers 200 only while the core is ``ready`` (503
while it starts, drains or has stopped); ``/v2/health/stats`` is the
core's ``health_snapshot()``, the signal a fleet router probes.

``/metrics`` serves the core's Prometheus exposition
(``InferenceServer.metrics_text``, the bytes the gRPC ``ServerMetrics``
unary carries).  The ``http.generate_stream`` fault point trips before
each SSE event write: ``raise`` severs the connection mid-stream, with
no terminal chunk, which drives a client's ``Last-Event-ID`` resume.
"""

import gzip
import json
import re
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote


from tpuserver_torch import fault_points
from tpuserver_torch.core import InferRequest, RequestedOutput
from tpuserver_torch.errors import BadRequest, ModelNotFound, TorchServeError
from tpuserver_torch.tensor_io import (
    array_from_binary,
    array_from_json_data,
    binary_from_array,
    json_from_array,
)

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
_REPO_URI = re.compile(
    r"^/v2/repository(/models/(?P<model>[^/]+)/(?P<verb>load|unload)|/index)$"
)


def _array_from_json(tin):
    datatype = tin.get("datatype")
    if not datatype:
        raise BadRequest(
            "generate input '{}' needs a datatype".format(tin.get("name")))
    if "shape" not in tin:
        raise BadRequest("input '{}' needs a shape".format(tin.get("name")))
    return array_from_json_data(tin.get("data"), datatype, tin["shape"])


def _response_json(resp):
    out = {"model_name": resp.model_name,
           "model_version": resp.model_version, "outputs": []}
    if resp.id:
        out["id"] = resp.id
    for spec, array in resp.outputs:
        entry = dict(spec)
        entry["data"] = json_from_array(array, spec["datatype"])
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

    def _read_body(self):
        """The request body, decompressed as ``Content-Encoding`` says."""
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            raise BadRequest("malformed Content-Length")
        body = self.rfile.read(n)
        encoding = self.headers.get("Content-Encoding")
        try:
            if encoding == "gzip":
                body = gzip.decompress(body)
            elif encoding == "deflate":
                body = zlib.decompress(body)
        except (OSError, EOFError, zlib.error) as e:
            raise BadRequest("malformed {} body: {}".format(encoding, e))
        return body

    def _read_json(self, body=None):
        try:
            return json.loads(
                (self._read_body() if body is None else body) or b"{}")
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
        with self.server.answering:
            self.server.n_answering += 1
        try:
            self._dispatch_path(method)
        except TorchServeError as e:
            retry_after = getattr(e, "retry_after", None)
            headers = (("Retry-After", str(int(retry_after))),) \
                if retry_after is not None else ()
            self._send_json({"error": str(e)}, e.code, headers)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        finally:
            with self.server.answering:
                self.server.n_answering -= 1
                self.server.answering.notify_all()

    def _dispatch_path(self, method):
        path = self.path.split("?", 1)[0]
        core = self.server.core
        if path == "/v2/health/live":
            return self._send(200)
        if path == "/v2/health/ready":
            return self._send(200 if core.server_ready() else 503)
        if path == "/v2/health/stats":
            return self._send_json(core.health_snapshot())
        if path in ("/v2", "/v2/"):
            return self._send_json(core.server_metadata())
        if path == "/metrics":
            return self._send(200, core.metrics_text().encode("utf-8"),
                              content_type="text/plain; version=0.0.4")
        if path == "/v2/models/stats":
            return self._send_json(core.model_statistics())
        if path == "/v2/logging":
            if method == "POST":
                return self._send_json(
                    core.update_log_settings(self._read_json()))
            return self._send_json(core.get_log_settings())
        if path == "/v2/trace/setting":
            if method == "POST":
                return self._send_json(core.update_trace_settings(
                    None, self._read_json())["settings"])
            return self._send_json(core.get_trace_settings()["settings"])
        m = _REPO_URI.match(path)
        if m:
            body = self._read_json()
            if m.group("verb") == "load":
                core.load_model(unquote(m.group("model")))
                return self._send_json({})
            if m.group("verb") == "unload":
                params = body.get("parameters") or {}
                core.unload_model(unquote(m.group("model")),
                                  params.get("unload_dependents", False))
                return self._send_json({})
            return self._send_json(core.repository_index(
                ready_only=bool(body.get("ready", False))))
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
            if rest == "/trace/setting":
                if method == "POST":
                    return self._send_json(core.update_trace_settings(
                        model, self._read_json())["settings"])
                return self._send_json(
                    core.get_trace_settings(model)["settings"])
            if rest == "/infer" and method == "POST":
                return self._infer(model, version)
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

    def _infer(self, model, version):
        pinned = []
        try:
            self._infer_pinned(model, version, pinned)
        finally:
            self._unpin(pinned)

    def _infer_pinned(self, model, version, pinned):
        """``/infer``'s body; ``pinned`` collects the input regions it
        pinned for the request's execution."""
        core = self.server.core
        body = self._read_body()
        header_length = self.headers.get("Inference-Header-Content-Length")
        if header_length is not None:
            try:
                json_len = int(header_length)
            except ValueError:
                raise BadRequest("malformed Inference-Header-Content-Length")
            request_json = self._read_json(body[:json_len])
            binary = body[json_len:]
        else:
            request_json = self._read_json(body)
            binary = b""
        parameters = dict(request_json.get("parameters") or {})
        binary_all_outputs = parameters.pop("binary_data_output", False)
        declared_in = None  # the model's inputs, for one without datatype
        inputs = {}
        offset = 0
        for tin in request_json.get("inputs", []):
            name = tin.get("name")
            datatype = tin.get("datatype")
            if not datatype:
                if declared_in is None:
                    declared_in = {t["name"]: t for t in core.model_metadata(
                        model, version)["inputs"]}
                datatype = declared_in.get(name, {}).get("datatype")
            if "shape" not in tin or not datatype:
                raise BadRequest(
                    "input '{}' needs a shape and a datatype".format(name))
            shape = tin["shape"]
            tparams = tin.get("parameters") or {}
            region = tparams.get("shared_memory_region")
            if region is not None:
                core.pin_shm_region(region)
                pinned.append(region)
                inputs[name] = core.read_shm_input(
                    region, tparams.get("shared_memory_byte_size", 0),
                    tparams.get("shared_memory_offset", 0), datatype, shape)
            elif "binary_data_size" in tparams:
                size = int(tparams["binary_data_size"])
                if offset + size > len(binary):
                    raise BadRequest(
                        "input '{}' runs past the binary data ({} + {} > {} "
                        "bytes)".format(name, offset, size, len(binary)))
                inputs[name] = array_from_binary(
                    binary[offset:offset + size], datatype, shape)
                offset += size
            elif "data" in tin:
                inputs[name] = array_from_json_data(tin["data"], datatype,
                                                    shape)
            else:
                raise BadRequest("input '{}' has no data and no "
                                 "shared-memory reference".format(name))
        requested = None
        if "outputs" in request_json:
            requested = []
            for tout in request_json["outputs"]:
                oparams = tout.get("parameters") or {}
                requested.append(RequestedOutput(
                    tout["name"],
                    binary_data=oparams.get("binary_data", False)
                    or binary_all_outputs,
                    class_count=oparams.get("classification", 0),
                    shm_region=oparams.get("shared_memory_region"),
                    shm_byte_size=oparams.get("shared_memory_byte_size", 0),
                    shm_offset=oparams.get("shared_memory_offset", 0)))
        request = InferRequest(model, version, request_json.get("id", ""),
                               inputs, parameters, requested)
        request.shm_input_regions = tuple(pinned)
        response = core.infer(request)
        self._unpin(pinned)

        out_json = {"model_name": response.model_name,
                    "model_version": response.model_version, "outputs": []}
        if response.id:
            out_json["id"] = response.id
        binary_parts = []
        for spec, array in response.outputs:
            entry = dict(spec)
            delivery = response.delivery(spec["name"])
            oparams = {}
            if array is None:
                oparams["shared_memory_region"] = delivery["shm_region"]
                oparams["shared_memory_byte_size"] = \
                    delivery["shm_byte_size"]
                if delivery["shm_offset"]:
                    oparams["shared_memory_offset"] = delivery["shm_offset"]
            elif (delivery["binary_data"] if requested is not None
                  else binary_all_outputs):
                raw = binary_from_array(array, spec["datatype"])
                oparams["binary_data_size"] = len(raw)
                binary_parts.append(raw)
            else:
                entry["data"] = json_from_array(array, spec["datatype"])
            if oparams:
                entry["parameters"] = oparams
            out_json["outputs"].append(entry)
        header = json.dumps(out_json).encode("utf-8")
        headers = []
        if binary_parts:
            payload = header + b"".join(binary_parts)
            headers.append(("Inference-Header-Content-Length",
                            str(len(header))))
            content_type = "application/octet-stream"
        else:
            payload = header
            content_type = "application/json"
        accept = self.headers.get("Accept-Encoding", "")
        if "gzip" in accept:
            payload = gzip.compress(payload)
            headers.append(("Content-Encoding", "gzip"))
        elif "deflate" in accept:
            payload = zlib.compress(payload)
            headers.append(("Content-Encoding", "deflate"))
        self._send(200, payload, content_type=content_type, headers=headers)

    def _generate(self, model, version, stream):
        pinned = []
        try:
            self._generate_pinned(model, version, stream, pinned)
        finally:
            self._unpin(pinned)

    def _unpin(self, pinned):
        """Release the regions ``_generate_pinned`` pinned (each once)."""
        while pinned:
            self.server.core.unpin_shm_region(pinned.pop())

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
            self._unpin(pinned)  # before the answer: see the final marker
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
        # the stream is over: its input regions unpin before the final
        # marker goes out, so a client that unregisters a region once it
        # read the marker is never refused 409 by a pin still held here
        self._unpin(pinned)
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
        # the requests being answered, which stop(grace) waits for
        self._httpd.answering = threading.Condition()
        self._httpd.n_answering = 0
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

    def stop(self, grace=None):
        """Stop listening.  With ``grace``, wait up to that many seconds
        for the requests being answered to finish writing (their handler
        threads are daemons, so a process that exits without the wait
        cuts them): a drained server's last streams end with their final
        event."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if grace:
            deadline = time.monotonic() + grace
            answering = self._httpd.answering
            with answering:
                while self._httpd.n_answering:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    answering.wait(remaining)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
            self._core.detach_frontend()
