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


class GenerationNotFound(TorchServeError):
    """A stream-resume request named a generation id this server does not
    hold (never issued, already resumed, or aged out of the replay
    buffer) — HTTP 404.  Replay state is local to one server."""

    def __init__(self, msg):
        super().__init__(msg, code=404)


class RegionPinned(TorchServeError):
    """An unregister named a shared-memory region that an in-flight
    generation or its token ring still references — HTTP 409.  The
    region stays registered; retry once the generation has finished."""

    def __init__(self, msg):
        super().__init__(msg, code=409)


class KvExportMissing(TorchServeError):
    """No live ``kvexport/<generation_id>`` region: the generation never
    exported its KV, or the export was released or expired with its
    replay entry — HTTP 404.  The caller falls back to prefill."""

    def __init__(self, msg):
        super().__init__(msg, code=404)


class KvExportClaimed(TorchServeError):
    """A KV export's descriptor was fetched a second time: the transfer
    is one-shot (one decode-side server attaches it) — HTTP 409."""

    def __init__(self, msg):
        super().__init__(msg, code=409)


class ServerUnavailable(TorchServeError):
    """The server is closed or the model is not ready — HTTP 503."""

    def __init__(self, msg):
        super().__init__(msg, code=503)


class TooManyRequests(TorchServeError):
    """Admission was shed (the scheduler's queue is full, or the KV page
    pool is exhausted) — HTTP 429.  ``retry_after`` is the seconds the
    ``Retry-After`` header asks the client to wait."""

    def __init__(self, msg, retry_after=1):
        super().__init__(msg, code=429)
        self.retry_after = retry_after


class SlotPoisoned(TorchServeError):
    """The generation's own decode output went non-finite; its slot was
    quarantined while co-batched generations go on — HTTP 422."""

    def __init__(self, msg):
        super().__init__(msg, code=422)


class RequestTimedOut(TorchServeError):
    """The request's deadline (its ``timeout`` parameter) passed before
    or during the generation — HTTP 504."""

    def __init__(self, msg):
        super().__init__(msg, code=504)
