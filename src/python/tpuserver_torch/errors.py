"""Typed errors of the port's serving core, each carrying its HTTP code.

Counterpart of ``tpuserver/errors.py``; the names differ on purpose so
the two hierarchies never collide."""


class TorchServeError(Exception):
    """Server-side error with an HTTP status code."""

    def __init__(self, msg, code=400):
        super().__init__(msg)
        self.code = code


class BadRequest(TorchServeError):
    """The request is malformed or asks for the impossible — HTTP 400."""

    def __init__(self, msg):
        super().__init__(msg, code=400)


class ModelNotFound(TorchServeError):
    """No such model, version or endpoint — HTTP 404."""

    def __init__(self, msg):
        super().__init__(msg, code=404)


class NotPortedYet(TorchServeError):
    """The request uses a feature of the JAX server that a later slice
    of the port brings — HTTP 501."""

    def __init__(self, msg):
        super().__init__(msg, code=501)


class ServerUnavailable(TorchServeError):
    """The server is closed or the model is not ready — HTTP 503."""

    def __init__(self, msg):
        super().__init__(msg, code=503)
