"""Process-wide interned error registry: a copy of ``bftkv_tpu/errors.py``
(imports rewritten to the port's ``devtools/lockwatch.py``).

Errors travel between client and server as strings (the transport tunnels
them in an ``x-error`` header) and must map back to the *identical* error
value on the far side so protocol code can compare and count them.
Capability parity with the reference's interned error map
(reference: bftkv.go:12-48), done the Python way: each error is a distinct
``Error`` *subclass* interned by message. That makes all of these work:

- ``raise ERR_BAD_TIMESTAMP`` — raises a fresh instance (no shared
  traceback state between concurrent raises);
- ``except ERR_BAD_TIMESTAMP:`` — catch a specific error;
- ``except Error as e:`` — catch any protocol error; ``e`` compares equal
  to the interned value and to any error with the same message, so errors
  can key dicts for majority-vote counting
  (reference: protocol/client.go:28-50).
"""

from __future__ import annotations

from bftkv_tpu_torch.devtools.lockwatch import named_lock


def _message_of(obj: object) -> str | None:
    m = getattr(obj, "message", None)
    return m if isinstance(m, str) else None


class _ErrorMeta(type):
    """Make error *classes* compare/hash by message, so a class, an
    instance of it, and a re-parsed wire error are all interchangeable."""

    def __eq__(cls, other: object) -> bool:
        other_m = _message_of(other)
        return other_m is not None and other_m == cls.message

    def __ne__(cls, other: object) -> bool:
        return not cls.__eq__(other)

    def __hash__(cls) -> int:
        return hash(cls.message)

    def __repr__(cls) -> str:  # pragma: no cover
        return f"Error({cls.message!r})"


class Error(Exception, metaclass=_ErrorMeta):
    """Base class for all bftkv_tpu_torch errors."""

    message: str = "error"

    def __init__(self, message: str | None = None):
        if message is not None:
            self.message = message
        super().__init__(self.message)

    def __eq__(self, other: object) -> bool:
        other_m = _message_of(other)
        return other_m is not None and other_m == self.message

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(self.message)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Error({self.message!r})"


_registry: dict[str, type[Error]] = {}
_lock = named_lock("errors.intern")


def new_error(message: str) -> type[Error]:
    """Create (or fetch) the interned error class for ``message``."""
    with _lock:
        err = _registry.get(message)
        if err is None:
            name = "Err_" + "".join(
                c if c.isalnum() else "_" for c in message
            )
            err = _ErrorMeta(name, (Error,), {"message": message})
            _registry[message] = err
        return err


def error_from_string(message: str) -> type[Error]:
    """Map a wire string back to the interned error value
    (reference: bftkv.go:40-48)."""
    return new_error(message)


# The shared error vocabulary (reference: bftkv.go:12-29).
ERR_INSUFFICIENT_NUMBER_OF_QUORUM = new_error("insufficient number of quorum")
ERR_INSUFFICIENT_NUMBER_OF_RESPONSES = new_error("insufficient number of responses")
ERR_INSUFFICIENT_NUMBER_OF_VALID_RESPONSES = new_error(
    "insufficient number of valid responses"
)
ERR_INVALID_QUORUM_CERTIFICATE = new_error("invalid quorum certificate")
ERR_INVALID_TIMESTAMP = new_error("invalid timestamp")
ERR_INVALID_SIGN_REQUEST = new_error("invalid signature request")
ERR_PERMISSION_DENIED = new_error("permission denied")
ERR_BAD_TIMESTAMP = new_error("bad timestamp")
ERR_EQUIVOCATION = new_error("equivocation error")
ERR_INVALID_VARIABLE = new_error("invalid variable")
ERR_UNKNOWN_COMMAND = new_error("unknown command")
ERR_MALFORMED_REQUEST = new_error("malformed request")
ERR_NO_MORE_WRITE = new_error("no more write")
ERR_AUTHENTICATION_FAILURE = new_error("authentication failure")
ERR_EXIST = new_error("already exist")
ERR_INVALID_USER_ID = new_error("invalid user ID")
ERR_INVALID_RESPONSE = new_error("invalid response")

# Crypto-layer errors (reference: crypto/crypto.go:16-33).
ERR_CERTIFICATE_NOT_FOUND = new_error("certificate not found")
ERR_KEY_NOT_FOUND = new_error("key not found")
ERR_INVALID_SIGNATURE = new_error("invalid signature")
ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES = new_error(
    "insufficient number of signatures"
)
ERR_INVALID_TRANSPORT_SECURITY_DATA = new_error(
    "invalid transport security data"
)
ERR_NO_AUTHENTICATION_DATA = new_error("no authentication data")
ERR_INVALID_AUTHENTICATION_DATA = new_error("invalid authentication data")
ERR_TOO_MANY_ATTEMPTS = new_error("too many authentication attempts")
ERR_UNSUPPORTED_ALGORITHM = new_error("unsupported algorithm")
ERR_SHARE_NOT_FOUND = new_error("share not found")
ERR_INSUFFICIENT_NUMBER_OF_SECRETS = new_error("insufficient number of secrets")
ERR_CONTINUE = new_error("continue")  # threshold phase loop sentinel
ERR_DECRYPTION_FAILURE = new_error("decryption failure")
# Session-keyed transport (this framework's addition, no reference
# analog): the receiver no longer holds the pairwise session the sender
# used; the sender re-bootstraps on seeing this.
ERR_UNKNOWN_SESSION = new_error("unknown transport session")

# Keyspace sharding (this framework's addition, no reference analog):
# the variable hash-routes to a quorum clique this replica is not a
# member of — an honest client never sees this, a misrouted or
# Byzantine request dies in admission.
ERR_WRONG_SHARD = new_error("wrong shard")


def wrong_shard_error(
    epoch: int | None = None, owner: int | None = None
) -> type[Error]:
    """The wrong-shard decline, optionally carrying a routing hint:
    the responder's route-table epoch and the owning shard index, so a
    stale-route client re-routes in-round instead of failing.  The
    bare form is kept for legacy servers (and for epoch-0 fleets,
    where there is nothing to hint) — both intern and tunnel through
    the x-error header like any other protocol error."""
    if epoch is None or owner is None:
        return ERR_WRONG_SHARD
    return new_error(f"wrong shard epoch={int(epoch)} owner={int(owner)}")


def parse_wrong_shard(err: object) -> tuple[int | None, int | None] | None:
    """``None`` if ``err`` is not a wrong-shard decline; else the
    ``(epoch, owner)`` hint — ``(None, None)`` for the bare legacy
    form.  Accepts error classes, instances, and wire strings."""
    m = _message_of(err)
    if m is None and isinstance(err, str):
        m = err
    if m is None or not m.startswith("wrong shard"):
        return None
    rest = m[len("wrong shard"):].strip()
    if not rest:
        return (None, None)
    out: dict[str, int] = {}
    for part in rest.split():
        k, sep, v = part.partition("=")
        if sep and v.isdigit():
            out[k] = int(v)
    if "epoch" in out and "owner" in out:
        return (out["epoch"], out["owner"])
    return (None, None)

# Edge gateway tier (this framework's addition, no reference analog):
# the gateway's bounded admission queue is full — the caller should
# back off or try another gateway; quorum state is untouched.
ERR_GATEWAY_OVERLOADED = new_error("gateway overloaded")
# A gateway fill whose collective signature failed verification against
# the owner quorum: the record is never cached and never served.
ERR_UNCERTIFIED_RECORD = new_error("uncertified record")

# Storage errors (reference: storage/storage.go).
ERR_NOT_FOUND = new_error("not found")

# Transport errors.
ERR_TRANSPORT = new_error("transport failure")
ERR_NONCE_MISMATCH = new_error("nonce mismatch")
