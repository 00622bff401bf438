"""The port's serving core: model registry, readiness, metadata and
decoupled (streaming) execution — a slim copy of ``tpuserver/core.py``'s
``TensorSpec``, ``InferRequest``, ``InferResponse``, ``Model`` and the
``InferenceServer`` verbs the generation path uses.  Transport-agnostic:
``tpuserver_torch.http_server`` speaks HTTP on top of it.
"""

import threading
import time

import numpy as np

from tpuserver_torch.errors import (
    BadRequest,
    ModelNotFound,
    RequestTimedOut,
    ServerUnavailable,
    TorchServeError,
)

SERVER_NAME = "tpuserver-torch"
SERVER_VERSION = "0.1.0"

#: KServe-v2 wire datatype of each numpy dtype the port's models emit
_WIRE_DTYPES = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
}
_NP_DTYPES = {v: k for k, v in _WIRE_DTYPES.items()}

#: a model's response dict may carry per-response parameters under this
#: key (the scheduled path's ``generation_id`` and ``seq``); the core
#: moves them to ``InferResponse.parameters``
RESPONSE_PARAMS_KEY = "__response_parameters__"


def wire_to_np_dtype(datatype):
    """numpy dtype of a KServe-v2 wire datatype (BadRequest if unknown)."""
    try:
        return _NP_DTYPES[datatype]
    except KeyError:
        raise BadRequest("unsupported datatype '{}'".format(datatype))


class TensorSpec:
    """Declared input/output tensor: name, wire datatype, dims (-1 dynamic)."""

    def __init__(self, name, datatype, shape):
        self.name = name
        self.datatype = datatype
        self.shape = list(shape)

    def as_metadata(self):
        return {"name": self.name, "datatype": self.datatype,
                "shape": list(self.shape)}


class InferRequest:
    """Transport-agnostic inference request."""

    def __init__(self, model_name, model_version="", request_id="",
                 inputs=None, parameters=None):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id
        self.inputs = inputs or {}  # name -> np.ndarray
        self.parameters = parameters or {}
        # time.monotonic() bound from the 'timeout' parameter, set by
        # InferenceServer.infer_stream; the scheduler expires by it
        self.deadline = None


class InferResponse:
    """Transport-agnostic inference response; ``outputs`` is a list of
    (spec dict name/datatype/shape, np.ndarray); ``parameters`` the
    per-response parameters (``generation_id``, ``seq``)."""

    def __init__(self, model_name, model_version, request_id, outputs,
                 parameters=None):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id
        self.outputs = outputs
        self.parameters = parameters or {}


class Model:
    """Base model: subclasses define specs and ``execute_stream(inputs,
    request)``, which yields ``dict name -> np.ndarray`` responses (the
    decoupled contract: zero or many)."""

    name = "model"
    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 0
    inputs = ()
    outputs = ()
    decoupled = False
    version = "1"
    instance_count = 1
    #: "gpu" for models that run on the card, "cpu" otherwise
    device_kind = "gpu"

    def config_dict(self):
        def tensors(specs):
            return [{"name": t.name, "data_type": "TYPE_" + t.datatype,
                     "dims": list(t.shape)} for t in specs]

        cfg = {
            "name": self.name,
            "platform": self.platform,
            "backend": self.backend,
            "max_batch_size": self.max_batch_size,
            "input": tensors(self.inputs),
            "output": tensors(self.outputs),
            "instance_group": [{
                "name": self.name + "_0",
                "kind": "KIND_GPU" if self.device_kind == "gpu"
                else "KIND_CPU",
                "count": self.instance_count,
            }],
            "version_policy": {"latest": {"num_versions": 1}},
        }
        if self.decoupled:
            cfg["model_transaction_policy"] = {"decoupled": True}
        return cfg

    def metadata_dict(self):
        return {
            "name": self.name,
            "versions": [self.version],
            "platform": self.platform,
            "inputs": [t.as_metadata() for t in self.inputs],
            "outputs": [t.as_metadata() for t in self.outputs],
        }

    def execute_stream(self, inputs, request):
        raise NotImplementedError

    def close(self):
        """Release what the model holds (optional)."""


class InferenceServer:
    """Models by name, readiness, and streaming execution.

    Lifecycle: ``ready`` until :meth:`close`, then ``stopped``; a
    stopped server answers not-ready and refuses inference."""

    def __init__(self, models=None):
        self._models = {}  # name -> Model
        self._ready = {}  # name -> bool
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        for m in models or []:
            self.register_model(m)

    def register_model(self, model, ready=True):
        with self._lock:
            self._models[model.name] = model
            self._ready[model.name] = ready

    def _get_model(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            ready = self._ready.get(name, False)
            closed = self._closed
        if model is None:
            raise ModelNotFound(
                "Request for unknown model: '{}' is not found".format(name))
        if version not in ("", model.version):
            raise ModelNotFound(
                "Request for unknown model version: '{}' version {}".format(
                    name, version))
        if closed or not ready:
            raise ServerUnavailable("Model '{}' is not ready".format(name))
        return model

    @staticmethod
    def _model_healthy(model):
        """A model may expose ``healthy()`` (the continuous-batching
        scheduler's state); absent means healthy."""
        probe = getattr(model, "healthy", None)
        return probe is None or bool(probe())

    def server_ready(self):
        """True while serving and every ready model is healthy."""
        with self._lock:
            if self._closed:
                return False
            models = [m for n, m in self._models.items()
                      if self._ready.get(n, False)]
        return all(self._model_healthy(m) for m in models)

    def model_ready(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            ready = (model is not None and not self._closed
                     and version in ("", model.version)
                     and self._ready.get(name, False))
        return ready and self._model_healthy(model)

    def server_metadata(self):
        return {"name": SERVER_NAME, "version": SERVER_VERSION,
                "extensions": ["model_configuration"]}

    def model_metadata(self, name, version=""):
        return self._get_model(name, version).metadata_dict()

    def model_config(self, name, version=""):
        return self._get_model(name, version).config_dict()

    @staticmethod
    def _resolve_deadline(request):
        """The request's ``timeout`` parameter (microseconds) as a
        ``time.monotonic()`` deadline on ``request.deadline``."""
        t = request.parameters.get("timeout")
        if t:
            try:
                request.deadline = time.monotonic() + int(t) / 1e6
            except (TypeError, ValueError):
                raise BadRequest(
                    "request parameter 'timeout' must be an integer "
                    "microsecond count (got {!r})".format(t))

    @staticmethod
    def _check_deadline(deadline, when):
        if deadline is not None and time.monotonic() >= deadline:
            raise RequestTimedOut(
                "request deadline expired {} execution".format(when))

    def infer_stream(self, request):
        """Execute a decoupled request; yields one InferResponse per
        response the model produces.  Failures inside the model surface
        as TorchServeError (a typed one, such as the scheduler's 429 shed
        or 503 shutdown, passes through, ValueError is a 400, anything
        else a 500).  A response produced past the request's
        deadline ends the stream with a 504."""
        model = self._get_model(request.model_name, request.model_version)
        if not model.decoupled:
            raise BadRequest(
                "model '{}' is not a decoupled model".format(model.name))
        self._resolve_deadline(request)
        self._check_deadline(request.deadline, "before")
        declared = {t.name: t for t in model.outputs}
        try:
            for out in model.execute_stream(dict(request.inputs), request):
                # a token produced past the deadline belongs to a request
                # whose client has stopped waiting
                self._check_deadline(request.deadline, "during")
                params = None
                if RESPONSE_PARAMS_KEY in out:
                    out = dict(out)
                    params = out.pop(RESPONSE_PARAMS_KEY)
                outputs = []
                for name, array in out.items():
                    array = np.asarray(array)
                    spec = declared.get(name)
                    datatype = (spec.datatype if spec is not None
                                else _WIRE_DTYPES[array.dtype])
                    outputs.append(({"name": name, "datatype": datatype,
                                     "shape": list(array.shape)}, array))
                yield InferResponse(model.name, model.version, request.id,
                                    outputs, params)
        except TorchServeError:
            raise
        except ValueError as e:
            raise BadRequest("model '{}': {}".format(model.name, e))
        except Exception as e:
            raise TorchServeError(
                "inference failed for model '{}': {}".format(model.name, e),
                code=500)

    def close(self):
        """Stop serving and let every model release what it holds.  Safe
        to call twice."""
        with self._lock:
            self._closed = True
            models = list(self._models.values())
        for model in models:
            model.close()
