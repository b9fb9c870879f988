"""Detached signatures and collective signatures, verified in batches on
the card (counterpart of ``bftkv_tpu/crypto/signature.py``).

Capability parity with the reference's ``Signature`` and
``CollectiveSignature`` interfaces (reference: crypto/crypto.go:56-75):

- an individual signature packet carries the signer id and may embed the
  signer's certificate (reference: crypto_pgp.go:310-405);
- a *collective* signature is a concatenation of individual detached
  signatures; ``combine`` appends new signers and reports completion once
  the quorum's ``is_sufficient`` predicate holds; ``verify`` counts
  distinct valid signers (reference: crypto_pgp.go:477-519).

``verify`` assembles **one batch** of (message, sig, key) triples across
all signers: through the installed ``VerifyDispatcher`` when there is one,
else through this object's ``VerifierDomain`` (the RNS verify chain, kernel
K1, on ``device``), instead of the Go reference's sequential per-signer
``CheckDetachedSignature`` loop — the O(n²) per-write cluster cost named in
SURVEY.md §2.  Share issuance (``Signer.issue_many``) rides the installed
``SignDispatcher`` (kernel K2 and K1's fault check), else the host.
"""

from __future__ import annotations

import io
import struct

from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.crypto import vcache
from bftkv_tpu_torch.errors import (
    ERR_CERTIFICATE_NOT_FOUND,
    ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES,
    ERR_INVALID_SIGNATURE,
)
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.packet import (
    SIGNATURE_TYPE_NATIVE,
    SignaturePacket,
    write_chunk,
)

__all__ = ["Signer", "CollectiveSignature", "parse_entries", "serialize_entries"]


def serialize_entries(entries: list[tuple[int, bytes]]) -> bytes:
    buf = io.BytesIO()
    for signer_id, sig in entries:
        buf.write(struct.pack(">Q", signer_id))
        write_chunk(buf, sig)
    return buf.getvalue()


def parse_entries(data: bytes | None) -> list[tuple[int, bytes]]:
    if not data:
        return []
    out: list[tuple[int, bytes]] = []
    off, n = 0, len(data)
    while off < n:
        if off + 16 > n:  # torn id or torn chunk header
            raise ERR_INVALID_SIGNATURE
        signer_id = int.from_bytes(data[off : off + 8], "big")
        length = int.from_bytes(data[off + 8 : off + 16], "big")
        off += 16
        if length > n - off:
            raise ERR_INVALID_SIGNATURE
        out.append((signer_id, data[off : off + length]))
        off += length
    return out


class Signer:
    """Issues detached signatures bound to one identity
    (reference: crypto_pgp.go:346-371).  ``key`` is an RSA or an ECDSA
    P-256 private key; signatures are issued in its algorithm, like the
    reference's algorithm-agnostic PGP layer (crypto_pgp.go:346-371)."""

    def __init__(self, key, certificate: certmod.Certificate):
        self.key = key
        self.cert = certificate

    def issue(self, tbs: bytes, *, include_cert: bool = True) -> SignaturePacket:
        return self.issue_many([tbs], include_cert=include_cert)[0]

    def issue_many(
        self, tbs_list: list[bytes], *, include_cert: bool = True
    ) -> list[SignaturePacket]:
        """Batch of detached signatures in ONE dispatcher submission.

        When a cross-request sign dispatcher is installed, concurrent
        handlers' share issuance batches into shared CRT-modexp
        launches and stops serializing on the GIL (host ``pow`` does
        not release it); without one, signing falls back to host.
        ``issue`` is the one-item form."""
        from bftkv_tpu_torch.ops import dispatch

        # Both algorithms ride the dispatcher when one is installed —
        # i.e. this process explicitly claimed a chip (--dispatch) —
        # so concurrent handlers' batches coalesce into shared device
        # launches (CRT modexp for RSA, nonce base-mults for EC) and
        # stop serializing on the GIL.  Signing stays host-side
        # otherwise: a sidecar-mode daemon must never initialize the
        # accelerator the sidecar owns.
        d = dispatch.get_signer()
        if d is not None and not d.prefer_host(len(tbs_list)):
            sigs = d.submit([(tbs, self.key) for tbs in tbs_list])
        elif certmod.is_ec(self.key):
            from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

            sigs = [_ecdsa.sign(tbs, self.key) for tbs in tbs_list]
        elif d is not None:
            # Calibration says these items end on host either way
            # (ops/dispatch.py install-time crossover): sign inline and
            # skip the collector wait + flush queue entirely.
            metrics.incr("sign.host", len(tbs_list))
            sigs = [rsa.sign(tbs, self.key) for tbs in tbs_list]
        else:
            sigs = [rsa.sign(tbs, self.key) for tbs in tbs_list]
        # Seed the verify memo: a signature this process just produced
        # with its own key verifies under its own certificate by the
        # scheme's correctness (crypto/vcache.py).
        for tbs, sig in zip(tbs_list, sigs):
            vcache.seed_own_signature(self.cert, tbs, sig)
        cert_bytes = self.cert.serialize() if include_cert else None
        return [
            SignaturePacket(
                type=SIGNATURE_TYPE_NATIVE,
                version=1,
                completed=True,
                data=serialize_entries([(self.cert.id, sig)]),
                cert=cert_bytes,
            )
            for sig in sigs
        ]


def _resolve_cert(
    signer_id: int,
    keyring,
    embedded: dict[int, certmod.Certificate],
) -> certmod.Certificate | None:
    c = keyring.get(signer_id) if keyring is not None else None
    if c is None:
        c = embedded.get(signer_id)
    return c


def _embedded_certs(pkt: SignaturePacket) -> dict[int, certmod.Certificate]:
    if not pkt.cert:
        return {}
    return {c.id: c for c in certmod.parse(pkt.cert)}


def signers(pkt: SignaturePacket | None) -> list[int]:
    """Ids of everyone who signed (no verification —
    reference: crypto_pgp.go:373-405). Malformed data yields []."""
    if pkt is None or not pkt.data:
        return []
    try:
        return [sid for sid, _ in parse_entries(pkt.data)]
    except Exception:
        return []


class CollectiveSignature:
    """Concatenated detached signatures with batched verification
    (reference: crypto_pgp.go:477-519)."""

    def __init__(self, verifier: rsa.VerifierDomain | None = None, *, device=None):
        """``device`` places the default ``VerifierDomain`` (``None``:
        ``cuda:0``; ``"cpu"``: the plain versions)."""
        self.verifier = verifier or rsa.VerifierDomain(device=device)

    def verify(
        self,
        tbss: bytes,
        ss: SignaturePacket | None,
        quorum,
        keyring,
        *,
        use_cache: bool = True,
    ) -> None:
        """Raise unless enough *distinct, quorum-member* signers verify.

        One batch over every entry — all signatures verify in a single
        kernel launch.  (One-job form of :meth:`verify_many`, so
        the single and batch write paths share one semantics.)

        ``use_cache=False`` bypasses the verified-signature memo
        (crypto/vcache.py) — required for TPA-protected records.
        """
        err = self.verify_many(
            [(tbss, ss)], quorum, keyring, use_cache=use_cache
        )[0]
        if err is not None:
            raise err

    def verify_many(
        self,
        jobs: list[tuple[bytes, SignaturePacket | None]],
        quorum,
        keyring,
        *,
        use_cache: bool = True,
    ) -> list[Exception | type | None]:
        """Batched form of :meth:`verify` for the batch write pipeline:
        every entry of every job rides in ONE device batch; returns one
        error (or ``None``) per job instead of raising.

        Entries whose exact (signer key, tbs, sig) triple is memoized as
        a past SUCCESSFUL verify (crypto/vcache.py) skip the device
        batch; fresh successes are memoized.  Only the math is cached —
        quorum sufficiency over the valid signer set is recomputed here
        on every call."""
        from bftkv_tpu_torch.ops import dispatch

        use_cache = use_cache and vcache.enabled()
        results: list[Exception | type | None] = [None] * len(jobs)
        items: list[tuple[bytes, bytes, rsa.PublicKey]] = []
        # Per job: [(cert, sig, items-index or -1 for a memo hit)].
        jobmeta: list[list[tuple]] = []
        # One batch's jobs typically embed the SAME merged cert set in
        # every item; parse each distinct byte string once per call.
        cert_cache: dict[bytes, dict[int, certmod.Certificate]] = {}
        for j, (tbss, ss) in enumerate(jobs):
            meta: list[tuple] = []
            try:
                entries = parse_entries(ss.data if ss else None)
                if ss is None or not ss.cert:
                    embedded = {}
                else:
                    embedded = cert_cache.get(ss.cert)
                    if embedded is None:
                        embedded = _embedded_certs(ss)
                        cert_cache[ss.cert] = embedded
                for signer_id, sig in entries:
                    c = _resolve_cert(signer_id, keyring, embedded)
                    if c is None:
                        continue
                    if use_cache and vcache.get(c, tbss, sig):
                        meta.append((c, sig, -1))
                    else:
                        meta.append((c, sig, len(items)))
                        items.append((tbss, sig, c.public_key))
            except Exception:
                results[j] = ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES
                jobmeta.append([])
                continue
            jobmeta.append(meta)
            if not meta:
                results[j] = ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES
        if items:
            d = dispatch.get()
            ok = (
                d.verify(items)
                if d is not None
                else self.verifier.verify_batch(items)
            )
        else:
            ok = []
        for j, meta in enumerate(jobmeta):
            if results[j] is not None:
                continue
            tbss = jobs[j][0]
            valid: set = set()
            for c, sig, idx in meta:
                if idx < 0:
                    valid.add(c)
                elif ok[idx]:
                    valid.add(c)
                    if use_cache:
                        vcache.put(c, tbss, sig)
            if not quorum.is_sufficient(list(valid)):
                results[j] = ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES
        return results

    def sign(
        self, signer: Signer, tbss: bytes, *, completed: bool = False
    ) -> SignaturePacket:
        """This node's share of a collective signature
        (reference: crypto_pgp.go:477-484)."""
        pkt = signer.issue(tbss)
        pkt.completed = completed
        return pkt

    def combine(
        self,
        ss: SignaturePacket | None,
        share: SignaturePacket,
        quorum,
        keyring=None,
    ) -> tuple[SignaturePacket, bool]:
        """Append ``share``'s entries into ``ss``; returns the updated
        packet and whether the signer set is now sufficient
        (reference: crypto_pgp.go:486-503)."""
        if ss is None or not ss.data:
            ss = SignaturePacket(
                type=SIGNATURE_TYPE_NATIVE, version=1, completed=False, data=b""
            )
        entries = dict(parse_entries(ss.data))
        # Refuse to merge mismatched packet types (reference:
        # crypto_pgp.go:506-511) or unparsable share bytes — the share is
        # simply not counted.
        try:
            if share.type == ss.type:
                for sid, sig in parse_entries(share.data):
                    entries.setdefault(sid, sig)
        except Exception:
            pass
        ss.data = serialize_entries(list(entries.items()))
        # Merge embedded certs so later verification can resolve signers
        # that are not yet in the verifier's keyring.
        merged = _embedded_certs(ss)
        if share.cert:
            try:
                for c in certmod.parse(share.cert):
                    merged.setdefault(c.id, c)
            except Exception:
                pass
        ss.cert = certmod.serialize_many(list(merged.values())) or None
        nodes = []
        for sid in entries:
            c = _resolve_cert(sid, keyring, merged)
            if c is not None:
                nodes.append(c)
        done = quorum.is_sufficient(nodes)
        ss.completed = done
        return ss, done


def verify_with_certificate(
    tbs: bytes,
    pkt: SignaturePacket | None,
    certificate: certmod.Certificate,
    *,
    use_cache: bool = True,
) -> None:
    """Verify a single-signer packet against a known certificate, in the
    certificate's own algorithm (reference: crypto/crypto.go:60, used by
    server.go:207; algorithm dispatch per crypto_pgp.go:310-405).

    Consults the verified-signature memo (crypto/vcache.py) unless
    ``use_cache=False``; only a SUCCESS is ever memoized — a failed
    verify raises without touching the cache."""
    if pkt is None or not pkt.data:
        raise ERR_INVALID_SIGNATURE
    use_cache = use_cache and vcache.enabled()
    for sid, sig in parse_entries(pkt.data):
        if sid == certificate.id:
            if use_cache and vcache.get(certificate, tbs, sig):
                return
            if certmod.verify_detached(tbs, sig, certificate):
                if use_cache:
                    vcache.put(certificate, tbs, sig)
                return
            raise ERR_INVALID_SIGNATURE
    raise ERR_INVALID_SIGNATURE


def issuer(
    pkt: SignaturePacket | None, keyring, extra: dict | None = None
) -> certmod.Certificate:
    """The (first) signer's certificate, from keyring or embedded.

    Embedded certs parse LAZILY: on the hot server paths the signer is
    nearly always in the keyring, and the per-item cert parse was a
    top handler cost at batch shapes.

    ``extra`` is a frame-level id→cert map (batch handlers harvest the
    carrier item's embedded cert once per frame); it backstops items
    whose own packet carries no cert because the client embedded the
    writer cert on the first batch item only."""
    if pkt is None or not pkt.data:
        raise ERR_CERTIFICATE_NOT_FOUND
    entries = parse_entries(pkt.data)
    if keyring is not None:
        for sid, _ in entries:
            c = keyring.get(sid)
            if c is not None:
                return c
    try:
        embedded = _embedded_certs(pkt)
    except Exception:
        embedded = {}
    for sid, _ in entries:
        c = embedded.get(sid)
        if c is None and extra is not None:
            c = extra.get(sid)
        if c is not None:
            return c
    raise ERR_CERTIFICATE_NOT_FOUND
