"""The fleet router's failure classes and failover policy.

The port's copy of the part of the client's shared retry module that
the router reads (``RetryPolicy``, ``FAILURE_CONNECT``,
``FAILURE_INTERRUPTED`` and what they reach): one definition of which
replica failures are safely failed over.  The router classifies each
replica failure with it exactly as the client's pool does, so a router
and a client pool agree on what fails over.
"""

#: Failure classes of the router's multi-replica failover.
#: An "interrupted" request (sent, outcome unknown) is only safe to
#: re-execute on another replica when the call is idempotent.
FAILURE_CONNECT = "connect"  # provably never reached a handler
FAILURE_OVERLOAD = "overload"  # typed shed-before-work (429/503/...)
FAILURE_INTERRUPTED = "interrupted"  # request sent, outcome unknown
FAILURE_OTHER = "other"  # typed non-overload response: server is alive


class RetryPolicy:
    """Which replica failures fail over to another replica.

    Only failures where the server provably did not complete the
    request fail over unconditionally: connection errors (refused or
    reset before a response) and the typed overload codes, HTTP 429
    and 503.  An interrupted request fails over only when the call is
    idempotent; any other typed response never does.
    """

    #: HTTP statuses typed as shed-before-work
    retryable_statuses = frozenset((429, 503))

    def classify_http_status(self, status):
        """Map an HTTP status to a failure kind (module constants)."""
        try:
            code = int(status)
        except (TypeError, ValueError):
            return FAILURE_OTHER
        return (
            FAILURE_OVERLOAD
            if code in self.retryable_statuses
            else FAILURE_OTHER
        )

    def should_failover(self, kind, idempotent=False):
        """Cross-endpoint failover decision (the router's and the pool's).

        Connect-phase and typed-overload failures always fail over: the
        rejecting server did no work, so another replica may.  An
        interrupted request fails over only when the caller marks the
        call idempotent: the first server may have executed it, and a
        second execution elsewhere must be safe.  Typed non-overload
        responses (4xx/5xx outside the overload set) never fail over,
        since every replica would answer the same."""
        if kind in (FAILURE_CONNECT, FAILURE_OVERLOAD):
            return True
        if kind == FAILURE_INTERRUPTED:
            return bool(idempotent)
        return False
