"""Serving exception types (the port's copy of the two in
``repro.serve.faults``).  Fault injection and the invariant auditor belong
to a later slice of the port."""


class ServeError(RuntimeError):
    """A request-lifecycle error the Server can attribute and explain."""


class QueueFull(ServeError):
    """``Server.submit`` past ``ServerConfig.max_pending`` under the
    "reject" backpressure policy (a later slice)."""
