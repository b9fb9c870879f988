"""Protocol server: the 13 command handlers behind decrypt→dispatch→encrypt
(counterpart of ``bftkv_tpu/protocol/server.py``).

Capability parity with the reference (protocol/server.go:33-620):
- ``sign`` — the guts of the write path: verify the writer's signature
  with its own certificate, require the writer's certificate to be
  signed by a CERT-quorum threshold (the *quorum certificate*,
  server.go:211-214), the equivocation check "never sign <x,t,v≠v'>"
  with revocation of double-signers (server.go:242-256), and persist
  the request *without* ss to mark the write in-progress
  (server.go:275-281);
- ``write`` — collective-signature sufficiency, timestamp /
  equivocation / TOFU checks (TOFU: a new issuer must match the
  previous issuer's id **or** uid, server.go:329-337);
- ``read`` — latest *completed* version (scan back past sign-only
  entries), TPA proof enforcement on protected variables
  (server.go:145-187);
- TPA session map per protected variable (server.go:375-448),
  ``register`` (decentralized enrollment, server.go:450-514),
  ``distribute``/``dist_sign`` with the ``!!!secret!!!`` hidden prefix
  (server.go:31,516-541), join/leave/revoke/notify maintenance.

Device seam: handlers are control flow; every signature verification
goes through ``crypt.collective`` / ``verify_with_certificate`` whose
batches run on the server's ``device`` (kernel K1 on ``cuda``), and the
server-side entry points are instrumented so the batching dispatcher can
coalesce concurrent requests.  ``device=None`` is ``cuda:0``, which
raises without CUDA; the tests pass ``"cpu"``.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import trace
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.crypto import auth as authmod
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import signature as sigmod
from bftkv_tpu_torch.crypto import vcache
from bftkv_tpu_torch.errors import error_from_string, wrong_shard_error
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.errors import (
    ERR_AUTHENTICATION_FAILURE,
    ERR_BAD_TIMESTAMP,
    ERR_CERTIFICATE_NOT_FOUND,
    ERR_EQUIVOCATION,
    ERR_EXIST,
    ERR_INVALID_QUORUM_CERTIFICATE,
    ERR_INVALID_SIGN_REQUEST,
    ERR_INVALID_SIGNATURE,
    ERR_INVALID_USER_ID,
    ERR_MALFORMED_REQUEST,
    ERR_NO_AUTHENTICATION_DATA,
    ERR_NO_MORE_WRITE,
    ERR_NOT_FOUND,
    ERR_PERMISSION_DENIED,
    ERR_TOO_MANY_ATTEMPTS,
    ERR_UNKNOWN_COMMAND,
    ERR_WRONG_SHARD,
)
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.protocol import MAX_UINT64, Protocol, Ref
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["Server", "HIDDEN_PREFIX", "MAX_UINT64"]

log = logging.getLogger("bftkv_tpu_torch.protocol.server")

# Threshold shares are stored under variables no client request may
# name directly (reference: server.go:31, time/read reject the prefix).
HIDDEN_PREFIX = b"!!!secret!!!"


class Server(Protocol):
    def __init__(self, self_node, qs, tr, crypt, storage, *, device=None):
        super().__init__(self_node, qs, tr, crypt, device=device)
        self.storage = storage
        # Per-variable TPA servers, LRU-bounded + idle-TTL'd: a hostile
        # client naming fresh variables would otherwise grow this map
        # without limit (the reference deletes on done/error,
        # server.go:441-447; we keep sessions alive for mid-handshake
        # peers, so bounding has to be explicit).  The anti-brute-force
        # attempt counter survives eviction in ``_auth_attempts``.
        self._auth: "OrderedDict[bytes, authmod.AuthServer]" = OrderedDict()
        self._auth_used: dict[bytes, float] = {}
        self._auth_attempts: "OrderedDict[bytes, int]" = OrderedDict()
        self._auth_lock = named_lock("server.auth")
        # Anti-entropy digest tree (``sync/``), built lazily on the
        # first SYNC_DIGEST/SYNC_PULL; every persist marks it dirty so
        # digests stay incremental.
        self._sync = None
        self._sync_lock = named_lock("server.sync")

    # -- anti-entropy plumbing (sync/) ------------------------------------

    def _persist(self, variable: bytes, t: int, data: bytes) -> None:
        """All handler writes go through here: storage write + digest
        invalidation for the anti-entropy plane."""
        with trace.span("storage.write", attrs={"bytes": len(data)}):
            self.storage.write(variable, t, data)
        tree = self._sync
        if tree is not None:
            tree.mark(variable)

    def _persist_many(self, entries) -> None:
        """Batch form of :meth:`_persist` — the group-commit seam.  A
        backend exposing ``write_batch`` (the §19 log engine) persists
        the whole coalesced batch under ONE durability barrier; every
        other backend falls back to per-item writes, so callers
        (BATCH_WRITE, ``admit_records``, the sync back-fill) can batch
        unconditionally."""
        entries = list(entries)
        if not entries:
            return
        wb = getattr(self.storage, "write_batch", None)
        if wb is not None and len(entries) > 1:
            nbytes = sum(len(d) for _v, _t, d in entries)
            with trace.span(
                "storage.write",
                attrs={"bytes": nbytes, "batch": len(entries)},
            ):
                wb(entries)
            tree = self._sync
            if tree is not None:
                for variable, _t, _d in entries:
                    tree.mark(variable)
            return
        for variable, t, data in entries:
            self._persist(variable, t, data)

    def _sync_tree(self):
        with self._sync_lock:
            if self._sync is None:
                from bftkv_tpu_torch.sync.digest import DigestTree

                self._sync = DigestTree(self.storage)
            return self._sync

    def pending_variables(
        self,
        limit: int = 4096,
        after: bytes | None = None,
        scan_window: int | None = None,
    ) -> tuple[list[tuple[bytes, int, bytes, object]], bytes | None]:
        """Commit-pending residue in this replica's own store: the
        latest version of every variable whose record carries a
        partial (non-completed) collective signature — a piggybacked
        write whose async back-fill never landed here.  The repair
        daemon (sync/daemon.py) certifies or demotes these.

        The scan is WINDOWED so steady state stays cheap: at most
        ``scan_window`` keys (sorted order, resuming after ``after``)
        are read+parsed per call — a large store of fully certified
        records costs one bounded slice per repair round, not a
        full-store parse sweep.  Returns ``(pending, next_cursor)``;
        ``next_cursor`` is None when the scan reached the end of the
        keyspace (the caller wraps around next round).

        Excluded by design: hidden-prefix (threshold-CA) state,
        TPA-protected records (certifying them needs the client's auth
        proof, which only a client holds), legacy sign-phase residue
        (``ss is None`` — the read path's scan-back + certify-on-read
        already owns that shape), and anything unparsable."""
        out: list[tuple[bytes, int, bytes, object]] = []
        cursor = None
        sk = getattr(self.storage, "sorted_keys", None)
        if sk is not None and scan_window is not None:
            # Storage-served cursor (§19 log engine): one bisect +
            # slice instead of re-sorting the whole keyspace every
            # repair round.  Ask for one extra key to learn whether
            # the window exhausted the keyspace.
            try:
                keys = sk(after=after, limit=scan_window + 1)
            except Exception:
                return out, None
            if len(keys) > scan_window:
                keys = keys[:scan_window]
                cursor = keys[-1]  # more keys remain past this window
        else:
            try:
                keys = sorted(self.storage.keys())
            except Exception:
                return out, None
            if after is not None:
                keys = [k for k in keys if k > after]
            if scan_window is not None and len(keys) > scan_window:
                keys = keys[:scan_window]
                cursor = keys[-1]  # more keys remain past this window
        for variable in keys:
            if len(out) >= limit:
                break
            if variable.startswith(HIDDEN_PREFIX):
                continue
            try:
                raw = self.storage.read(variable, 0)
                p = pkt.parse(raw)
            except Exception:
                # Unreadable/undecodable record: not repair-eligible —
                # the anti-entropy plane owns hostile storage bytes.
                continue
            if p.sig is None or p.auth is not None:
                continue
            if p.ss is None or p.ss.completed:
                continue
            out.append((variable, p.t, raw, p))
        return out, cursor

    # -- lifecycle (reference: server.go:47-62) ---------------------------

    def start(self, bind_host: str = "") -> None:
        """``bind_host`` overrides the listen interface (containers:
        0.0.0.0) while peers keep dialing the certificate address."""
        addr = self.self_node.address
        if addr:
            listen = _listen_addr(addr)
            if bind_host:
                listen = f"{bind_host}:{listen.rsplit(':', 1)[-1]}"
            self.tr.start(self, listen)
            log.info("server @ %s running (listen %s)", addr, listen)

    def stop(self) -> None:
        self.leaving()
        self.tr.stop()

    # -- dispatch (reference: server.go:562-620) --------------------------

    def handler(self, cmd: int, data: bytes) -> bytes | None:
        """decrypt → dispatch → encrypt.  Errors raise; the transport
        layer tunnels them back (x-error header / loopback raise)."""
        plain, sender, nonce = self.crypt.message.decrypt(data)
        # The client's trace context rides a plaintext envelope inside
        # the encrypted payload (packet.wrap_trace, prepended by the
        # multicast fan-out); strip it before the handlers parse.
        tctx, plain = pkt.unwrap_trace(plain)
        # "peer" is the sender as *we* know it — None on first contact
        # (the reference's nil peer, server.go:566-569).
        peer = self.crypt.keyring.get(sender.id)

        name = self._handlers.get(cmd)
        if name is None:
            raise ERR_UNKNOWN_COMMAND
        cmd_name = tp.COMMAND_NAMES.get(cmd, cmd)
        metrics.incr(f"server.{cmd_name}.count")
        # Dispatch by name so subclasses (the Byzantine Mal* family,
        # reference: malserver_test.go:23-194) override handlers by
        # plain method definition.
        run = getattr(self, name)
        if fp.ARMED:
            # ``server.admission`` failpoint: error reply, crash, or a
            # Byzantine handler override (faults/byzantine.py programs).
            act = fp.fire(
                "server.admission",
                node=getattr(self.self_node, "name", ""),
                cmd=cmd_name,
            )
            if act is not None:
                run = self._admission_fault(act, cmd, run)
        if tctx is not None:
            with trace.attach(trace.SpanContext(*tctx)), trace.span(
                f"server.{cmd_name}",
                attrs={"node": getattr(self.self_node, "name", "")},
            ):
                res = run(plain, peer, sender)
        else:
            res = run(plain, peer, sender)
        return self.crypt.message.encrypt([sender], res or b"", nonce)

    def _admission_fault(self, act, cmd: int, run):
        """Interpret one fired ``server.admission`` action as a handler
        replacement: ``error`` raises the named interned error,
        ``delay`` stalls then serves honestly, ``crash`` takes this
        replica's transport down mid-request, ``handle`` substitutes a
        Byzantine program ``fn(server, cmd, req, peer, sender)``."""
        if act.kind == "error":
            msg = act.params.get("error", "internal error")

            def run_error(req, peer, sender):
                raise error_from_string(msg)

            return run_error
        if act.kind == "delay":

            def run_delayed(req, peer, sender):
                time.sleep(fp.delay_seconds(act))
                return run(req, peer, sender)

            return run_delayed
        if act.kind == "crash":

            def run_crash(req, peer, sender):
                self.tr.stop()  # the node goes dark for everyone
                raise tp.ERR_UNREACHABLE

            return run_crash
        if act.kind == "handle":
            fn = act.params["fn"]
            return lambda req, peer, sender: fn(self, cmd, req, peer, sender)
        return run

    # -- keyspace sharding admission gate ---------------------------------

    def _wrong_shard(self, variable: bytes, stale: bool = False) -> None:
        """Count and raise the wrong-shard decline.  With an installed
        route epoch the decline carries the responder's epoch and the
        owning shard index so a stale-route client re-routes in-round;
        epoch-0 fleets (and non-epoched quorum systems) keep raising
        the bare interned form legacy clients already understand.
        ``stale``: the misroute looks stale-ROUTED (an epoch flip moved
        the bucket away from here) rather than Byzantine — the
        ``server.epoch_stale`` counter feeds the fleet collector's
        ``epoch_skew`` anomaly."""
        qs = self.qs
        # Labeled by the shard THIS replica serves (a closed enum:
        # shard indices, bounded by the clique count) — the fleet
        # collector's anomaly feed attributes misroutes per shard.
        # Unlabeled when the seat is momentarily unknown (topology
        # regenerating): a string fallback under the same name
        # would make Prometheus' sorted() comparison of int and
        # str label values raise.
        my_shard = getattr(qs, "my_shard", lambda: None)()
        labels = {"shard": my_shard} if my_shard is not None else None
        metrics.incr("server.wrong_shard", labels=labels)
        if stale:
            metrics.incr("server.epoch_stale", labels=labels)
        hint = getattr(qs, "route_hint", None)
        if (
            hint is not None
            and getattr(qs, "route_epoch", lambda: 0)() > 0
        ):
            epoch, owner = hint(variable)
            if owner is not None:
                raise wrong_shard_error(epoch, owner)
        raise ERR_WRONG_SHARD

    def _shard_check(self, variable: bytes, write: bool = True) -> str:
        """Admission gate for keyspace routing; returns this replica's
        role for ``variable`` (``owner`` / ``dual`` / ``foreign``).

        On unsharded trust graphs (and for quorum systems without keyed
        routing) this is a no-op, so single-clique clusters behave
        bit-for-bit as before.  The gate is what makes cross-shard
        collective signatures unmintable: the only replicas that will
        sign or store <x,...> are the owner clique's, so a signature
        gathered anywhere else can never reach the owner quorum's
        threshold.

        Epoched routing refines the gate (DESIGN.md §15):

        - a ``dual`` replica (old owner inside the dual-epoch window)
          passes here; the write-path handlers then restrict it to
          versions it ALREADY stored (``_dual_write_ok``) — it keeps
          serving and certifying, it never mints a new version, so the
          new owner stays the single write serializer and invariant 5
          survives the flip;
        - ``foreign`` READS are served (not declined) once an epoch is
          installed — the inert-stale-copy rule: a replica straddling a
          flip keeps serving what it has while refusing new writes for
          buckets it no longer owns."""
        qs = self.qs
        role_of = getattr(qs, "route_role", None)
        if role_of is None:
            owns = getattr(qs, "owns", None)
            if owns is not None and not owns(variable):
                self._wrong_shard(variable)
            return "owner"
        role = role_of(variable)
        if role == "foreign":
            if (
                not write
                and getattr(qs, "route_epoch", lambda: 0)() > 0
            ):
                metrics.incr("server.read.foreign")
                return role
            stale = getattr(qs, "stale_routed", lambda _x: False)
            self._wrong_shard(variable, stale=stale(variable))
        return role

    def _dual_write_ok(self, variable: bytes, t: int, val) -> bool:
        """What a dual-window (old owner) replica may still admit on
        the write plane: exactly the versions it already stored — the
        back-fill / certify / idempotent-retry shapes of in-flight
        writes that started before the flip.  Anything NEW must go to
        the new owner (the decline hint sends the client there)."""
        try:
            vt = self.storage.read(variable, t)
        except Exception:
            return False
        try:
            return pkt.parse(vt).value == val
        except Exception:
            return False

    # -- membership (reference: server.go:64-120) -------------------------

    def _join(self, req: bytes, peer, sender) -> bytes | None:
        if peer is not None and peer.id == self.self_node.id:
            log.info("server [%s]: joining to itself?", peer.name)
            return None
        nodes = certmod.parse(req)
        certs: list = []
        if peer is not None:
            # Accept only the peer's own certificate.
            certs = [n for n in nodes if n.id == peer.id]
        elif nodes:
            # First contact: trust the first certificate.
            if nodes[0].id == self.self_node.id:
                log.info("server [%s]: joining to itself?", nodes[0].name)
                return None
            certs = [nodes[0]]
        certs = self.self_node.add_peers(certs)
        try:
            self.crypt.keyring.register(certs)
        except Exception:
            self.self_node.remove_peers(certs)  # stay consistent
            raise
        # Reply with our whole view so the joiner can crawl the graph.
        return self.self_node.serialize_nodes()

    def _leave(self, req: bytes, peer, sender) -> bytes | None:
        nodes = certmod.parse(req)
        for n in nodes:
            if peer is not None and n.id == peer.id:
                self.self_node.remove_peers([n])
                # the key stays in the keyring (reference: server.go:115)
        return None

    # -- timestamps (reference: server.go:122-143) ------------------------

    def _time(self, req: bytes, peer, sender) -> bytes:
        variable = req
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        if self._shard_check(variable) == "dual":
            # A TIME answer would keep a stale classic writer minting
            # NEW versions at the old owner — send it to the new one.
            self._wrong_shard(variable, stale=True)
        t = 0
        try:
            raw = self.storage.read(variable, 0)
            t = pkt.parse(raw).t
        except ERR_NOT_FOUND:
            pass
        if fp.ARMED:
            # ``server.time`` failpoint: clock skew on the timestamp
            # path — this replica's answers shift by delta (clamped to
            # the valid range; MAX_UINT64 stays the write-once marker).
            act = fp.fire(
                "server.time", node=getattr(self.self_node, "name", "")
            )
            if act is not None and act.kind == "skew":
                t = min(max(t + int(act.params.get("delta", 0)), 0),
                        MAX_UINT64 - 1)
        return t.to_bytes(8, "big")

    # -- read (reference: server.go:145-187) ------------------------------

    def _read(self, req: bytes, peer, sender) -> bytes | None:
        p = pkt.parse(req)
        # ``t == 1`` in a read request asks for the latest CERTIFIED
        # record only (skip commit-pending) — the reader's fallback
        # after a pending winner failed to certify.  Old servers ignore
        # the request's t and never serve pending records, so the flag
        # degrades to their behavior exactly.
        return self._read_item(
            p.variable or b"", p.ss, certified_only=(p.t == 1)
        )

    def _read_item(
        self, variable: bytes, proof, certified_only: bool = False
    ) -> bytes | None:
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        self._shard_check(variable, write=False)
        raw = None
        authenticated = None
        try:
            raw = self.storage.read(variable, 0)
        except ERR_NOT_FOUND:
            raw = None
        if raw is not None:
            stored = pkt.parse(raw)
            authenticated = stored.auth
            if (
                stored.ss is not None
                and not stored.ss.completed
                and certified_only
            ):
                # Scan back exactly as for a sign-phase record.
                raw = None
                for t in self._versions_below(variable, stored.t):
                    try:
                        candidate = self.storage.read(variable, t)
                    except ERR_NOT_FOUND:
                        continue
                    cp = pkt.parse(candidate)
                    if cp.ss is not None and cp.ss.completed:
                        raw = candidate
                        break
            elif stored.ss is not None and not stored.ss.completed:
                # Commit-pending piggyback record (WRITE_SIGN persists
                # with a partial, non-completed ss; the legacy sign
                # phase persists ss=None): SERVE it.  The client-side
                # resolve accepts it only through the resolve path — a
                # responder threshold plus certify-on-read when no
                # completed collective signature is in the bucket — so
                # a bare value is never served off one replica's word
                # (DESIGN.md §12.3).
                metrics.incr("server.read.pending")
            elif stored.ss is None:
                # A sign request arrived but the write never completed —
                # scan back for the last completed version
                # (reference: server.go:166-180).
                raw = None
                for t in self._versions_below(variable, stored.t):
                    try:
                        candidate = self.storage.read(variable, t)
                    except ERR_NOT_FOUND:
                        continue
                    cp = pkt.parse(candidate)
                    if cp.ss is not None and cp.ss.completed:
                        raw = candidate
                        break
        if authenticated is not None:
            if proof is None:
                raise ERR_AUTHENTICATION_FAILURE
            try:
                # TPA-protected record: the verify memo is never
                # consulted for auth proofs (crypto/vcache.py).
                self.crypt.collective.verify(
                    variable,
                    proof,
                    qm.choose_quorum_for(self.qs, variable, qm.AUTH),
                    self.crypt.keyring,
                    use_cache=False,
                )
            except Exception:
                raise ERR_AUTHENTICATION_FAILURE from None
        return raw

    def _versions_below(self, variable: bytes, t: int):
        """Stored version timestamps < ``t``, descending.  Prefers the
        backend's version listing; falls back to a bounded countdown
        (an incomplete write-once at 2^64-1 must not spin forever)."""
        versions = getattr(self.storage, "versions", None)
        if versions is not None:
            try:
                return sorted(
                    (v for v in versions(variable) if v < t), reverse=True
                )
            except Exception:
                pass  # backend's versions() broken: bounded scan below
        return range(t - 1, max(0, t - 1024), -1)

    # -- sign (reference: server.go:189-284) ------------------------------

    def _sign(self, req: bytes, peer, sender) -> bytes:
        p = pkt.parse(req)
        variable, val, t, sig, ss = p.variable or b"", p.value, p.t, p.sig, p.ss
        if sig is None:
            raise ERR_MALFORMED_REQUEST
        # Hardening beyond the reference (which guards only time/read,
        # server.go:126,153): a client-visible sign/write of a
        # hidden-prefix variable would shadow threshold-CA shares
        # stored there by _distribute.
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        if (
            self._shard_check(variable) == "dual"
            and not self._dual_write_ok(variable, t, val)
        ):
            self._wrong_shard(variable, stale=True)

        # Verify the writer's signature with its own certificate.
        issuer = sigmod.issuer(sig, self.crypt.keyring)
        tbs = pkt.tbs(req)
        with trace.span(
            "server.verify_batch",
            attrs={"batch_size": 1, "kind": "writer_sig"},
        ):
            sigmod.verify_with_certificate(tbs, sig, issuer)
        # The presented cert may carry a richer quorum certificate
        # than this replica's keyring copy; check against a transient
        # enriched view (never persisted — see _present).
        if sig.cert:
            try:
                for c in certmod.parse(sig.cert):
                    if c.id == issuer.id:
                        issuer = self._present(c)
                        break
            except Exception:
                # Unparsable embedded chain: keep the presented issuer;
                # the qcert check right below is the authority.
                pass
        self._check_quorum_certificate(issuer)

        proof = self._sign_storage_checks(variable, val, t, sig, ss)

        tbss = pkt.tbss(req)
        share = self.crypt.collective.sign(self.crypt.signer, tbss)
        res = pkt.serialize_signature(share)

        # Persist the request *without* ss — marks the write in-progress
        # (reference: server.go:275-281).
        stored = pkt.serialize(variable, val, t, sig, None, proof)
        self._persist(variable, t, stored)
        metrics.incr("server.sign.ok")
        return res

    def _check_quorum_certificate(self, issuer) -> None:
        """The writer's certificate must carry VALID signatures from a
        CERT-quorum threshold (reference: server.go:211-214).

        Each counted signature is cryptographically verified (memoized
        per (signer, sig-bytes) on the cert object): embedded certs
        presented by writers merge into the keyring copy
        (:meth:`_merge_embedded`, the reference's merge-on-import,
        crypto_pgp.go:186-204), so an id-only count would let a writer
        claim arbitrary signer ids and mint a quorum certificate."""
        q = self.qs.choose_quorum(qm.AUTH | qm.CERT)
        cache = issuer.__dict__.setdefault("_qcert_ok", {})
        tbs = None
        signer_nodes = []
        for sid, sig_bytes in list(issuer.signatures.items()):
            c = self.crypt.keyring.get(sid)
            if c is None:
                continue
            ok = cache.get((sid, sig_bytes))
            if ok is None:
                if tbs is None:
                    tbs = issuer.tbs()
                # The process-wide verify memo spans cert *instances*
                # (keyring copy vs transient _present clones), so a
                # presented rich cert re-verifies each endorsement at
                # most once per process, not once per clone.
                if vcache.enabled() and vcache.get(c, tbs, sig_bytes):
                    ok = True
                else:
                    ok = certmod.verify_detached(tbs, sig_bytes, c)
                    if ok and vcache.enabled():
                        vcache.put(c, tbs, sig_bytes)
                cache[(sid, sig_bytes)] = ok
            if ok:
                signer_nodes.append(c)
        if not q.is_threshold(signer_nodes):
            raise ERR_INVALID_QUORUM_CERTIFICATE

    def _present(self, cert):
        """TRANSIENT view of a presented certificate: the keyring copy
        enriched with the presented signature set, never persisted.

        A writer whose quorum certificate was accumulated across
        replicas presents the rich copy; this replica's sparse keyring
        copy must not shadow it (the reference converges rings by
        merge-on-import, crypto_pgp.go:186-204).  But persisting the
        merge would be unsound the other way: the trust GRAPH derives
        edges from keyring signature sets, so a client presenting a
        cert copy carrying extra *valid* third-party certifications
        (public data) would silently add edges to this replica's graph
        and reshape its quorums.  Hence: enrich a throwaway clone for
        the signature-count check; the keyring and graph keep only
        ring-sourced edges.  Every counted signature is still verified
        cryptographically (:meth:`_check_quorum_certificate`)."""
        have = self.crypt.keyring.get(cert.id)
        if have is None:
            return cert
        if all(sid in have.signatures for sid in cert.signatures):
            return have  # nothing new: keep the memoized keyring copy
        rich = certmod.Certificate(
            n=have.n, e=have.e, name=have.name, address=have.address,
            uid=have.uid, alg=have.alg, point=have.point,
            signatures=dict(have.signatures),
        )
        try:
            rich.merge(cert)
        except Exception:
            return have
        return rich

    def _sign_storage_checks(self, variable, val, t, sig, ss):
        """The per-variable part of ``sign``: TPA proof, write-once,
        equivocation, and timestamp checks against the stored version
        (reference: server.go:232-262).  Returns the auth params to
        inherit into the persisted record."""
        rdata = None
        try:
            rdata = self.storage.read(variable, 0)
        except ERR_NOT_FOUND:
            pass

        proof = None
        if rdata is not None:
            rp = pkt.parse(rdata)
            # TPA check first (reference: server.go:232-241): ``ss`` in
            # the sign request carries the client's auth proof.
            if rp.auth is not None:
                if ss is None:
                    raise ERR_AUTHENTICATION_FAILURE
                try:
                    # TPA-protected record: bypass the verify memo.
                    self.crypt.collective.verify(
                        variable,
                        ss,
                        qm.choose_quorum_for(self.qs, variable, qm.AUTH),
                        self.crypt.keyring,
                        use_cache=False,
                    )
                except Exception:
                    raise ERR_AUTHENTICATION_FAILURE from None
            # Never sign both <x,t,v> and <x,t,v'>
            # (reference: server.go:242-262).  Re-signing the EXACT
            # stored <t, value> stays allowed even at the write-once
            # ceiling: it issues no second signature over anything new,
            # and it is how a reader certifies a commit-pending
            # write-once record (client._certify_pending).
            if rp.t == MAX_UINT64 and not (t == rp.t and val == rp.value):
                raise ERR_NO_MORE_WRITE
            if t == rp.t and val != rp.value:
                if self._revoke_signers(
                    sigmod.signers(sig), sigmod.signers(rp.sig)
                ):
                    metrics.incr("server.equivocation")
                    raise ERR_EQUIVOCATION
                raise ERR_INVALID_SIGN_REQUEST  # someone beat me
            if t < rp.t:
                raise ERR_BAD_TIMESTAMP
            proof = rp.auth  # inherit the auth params
        return proof

    # -- write (reference: server.go:286-352) -----------------------------

    def _write(self, req: bytes, peer, sender) -> bytes | None:
        p = pkt.parse(req)
        variable, val, t, sig, ss = p.variable or b"", p.value, p.t, p.sig, p.ss
        if sig is None or ss is None:
            raise ERR_MALFORMED_REQUEST
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        role = self._shard_check(variable)
        if role == "dual" and not self._dual_write_ok(variable, t, val):
            self._wrong_shard(variable, stale=True)

        # Sufficient quorum members must have signed the same <x,v,t> —
        # against the OWNER shard's quorum, so a collective signature
        # gathered from another clique is rejected in admission.
        tbss = pkt.tbss(req)
        with trace.span(
            "server.verify_batch",
            attrs={
                "batch_size": len(sigmod.signers(ss)),
                "kind": "collective",
            },
        ):
            try:
                self.crypt.collective.verify(
                    tbss,
                    ss,
                    qm.choose_quorum_for(self.qs, variable, qm.AUTH),
                    self.crypt.keyring,
                )
            except Exception:
                # A write arriving with a collective signature that does
                # not verify against the owner quorum is exactly the
                # Byzantine signal the fleet health plane watches for.
                metrics.incr("server.verify.collective_fail")
                raise

        out = self._write_storage_checks(variable, val, t, sig, ss, req)
        if out is not None:  # None = idempotent no-op (see checks)
            self._persist(variable, t, out)
        metrics.incr("server.write.ok")
        return None

    def _write_storage_checks(
        self, variable, val, t, sig, ss, req, frame_embedded=None
    ) -> bytes | None:
        """The per-variable part of ``write``: write-once, timestamp,
        equivocation, and TOFU checks against the stored version
        (reference: server.go:314-345).  Returns the bytes to persist
        (the request, with inherited auth params folded in), or
        ``None`` for an idempotent no-op (a stale-version certification
        already satisfied — see ``_stale_version_upgrade``).

        ``frame_embedded`` (id→cert) backstops TOFU issuer resolution
        for batch items whose sig carries no cert of its own (the
        client embeds the writer cert on the first item only) — and is
        folded back into the PERSISTED record, which later overwrites
        must resolve standalone (the frame is gone by then)."""
        rdata = None
        try:
            rdata = self.storage.read(variable, 0)
        except ERR_NOT_FOUND:
            pass

        out = req
        if not sig.cert and frame_embedded:
            # Mid-join writer, non-carrier item: restore the cert the
            # single-item path would have persisted, so the stored
            # record stays issuer-resolvable on its own.
            for sid, _ in sigmod.parse_entries(sig.data):
                if self.crypt.keyring.get(sid) is not None:
                    break
                fe = frame_embedded.get(sid)
                if fe is not None:
                    sig.cert = fe.serialize()
                    out = pkt.serialize(
                        variable, val, t, sig, ss, pkt.parse(req).auth
                    )
                    break
        if rdata is not None:
            rp = pkt.parse(rdata)
            # The exact stored <t, value> is re-admittable even at the
            # write-once ceiling: that is the back-fill certifying a
            # commit-pending write-once record (and a read-repair
            # re-delivering a completed one) — idempotent, not a
            # second write.
            if rp.t == MAX_UINT64 and not (t == rp.t and val == rp.value):
                raise ERR_NO_MORE_WRITE
            if t < rp.t:
                # Below the latest stored version — USUALLY a stale
                # write.  One case is not: the collective back-fill of
                # a committed collapsed write arriving after a newer
                # commit-PENDING version landed (a failed racer's
                # residue, or simply the next write outrunning this
                # one's async tail).  Certifying the exact version this
                # replica already admitted at t must not be blocked, or
                # residue at the top could starve the plane of ANY
                # completed record (DESIGN.md §12.3).
                return self._stale_version_upgrade(variable, val, t, out)
            if t == rp.t and val != rp.value:
                if rp.ss is not None:
                    self._revoke_signers(
                        sigmod.signers(ss), sigmod.signers(rp.ss)
                    )
                if not (
                    ss is not None
                    and ss.completed
                    and (rp.ss is None or not rp.ss.completed)
                ):
                    metrics.incr("server.equivocation")
                    raise ERR_EQUIVOCATION
                # A CERTIFIED record (its collective signature already
                # verified by the caller) beats uncertified residue at
                # the same timestamp: the quorum endorsed this value,
                # the residue is a failed racer's leftovers — refusing
                # would leave this replica permanently divergent.
                # Double-signers were still swept above.
                metrics.incr("server.write.residue_replaced")

            # TOFU: the new issuer must match the CERTIFIED owner's id
            # or uid (reference: server.go:329-337; residue never owns,
            # see _tofu_prev_sig).
            prev_sig = self._tofu_prev_sig(variable, rp)
            if prev_sig is not None:
                new_issuer = sigmod.issuer(
                    sig, self.crypt.keyring, frame_embedded
                )
                prev_issuer = sigmod.issuer(
                    prev_sig, self.crypt.keyring, frame_embedded
                )
                if (
                    prev_issuer.id != new_issuer.id
                    and prev_issuer.uid != new_issuer.uid
                ):
                    raise ERR_PERMISSION_DENIED

            if rp.auth is not None:  # inherit auth params
                out = pkt.serialize(variable, val, t, sig, ss, rp.auth)

        return out

    # -- round-collapsed write (piggyback; no reference analog) ------------

    def _signs_for(self, variable: bytes) -> bool:
        """Whether this replica holds a seat in the sign (AUTH) quorum
        that owns ``variable`` — i.e. whether its WRITE_SIGN ack should
        carry a collective-signature share.  Storage-plane complement
        nodes ack without a share: their signatures could never count
        toward ``suff`` anyway (is_sufficient tallies clique members
        only), and skipping the private-key op keeps the write plane as
        cheap as the legacy WRITE round.  Epoched quorum systems answer
        directly (``WotQS.signs_for``) — a dual-window old owner keeps
        a sign seat for versions it already stored."""
        fn = getattr(self.qs, "signs_for", None)
        if fn is not None:
            return fn(variable)
        qa = qm.choose_quorum_for(self.qs, variable, qm.AUTH)
        myid = self.self_node.get_self_id()
        return any(n.id == myid for n in qa.nodes())

    def _write_sign(self, req: bytes, peer, sender) -> bytes:
        """ONE round carrying what sign + write did in two: verify the
        writer (signature + quorum certificate), run the write-path
        storage checks, persist the record as COMMIT-PENDING (partial
        ss, completed=False), and piggyback this replica's collective-
        signature share inside the ack (packet.serialize_ws_ack).

        Timestamp admission is STRICT — the request's ``t`` must exceed
        the stored timestamp (the sole exception: re-acking the exact
        stored <t, value>, which keeps client retries idempotent).  A
        stale optimistic guess is answered with a DECLINE hint carrying
        the stored timestamp, never with a share and never with the
        equivocation revocation: this replica refuses to sign at or
        below its stored timestamp, so the "never sign both <x,t,v>
        and <x,t,v'>" invariant holds by construction, and an honest
        client whose lease went stale cannot be mistaken for a
        Byzantine double-signer (DESIGN.md §12.2)."""
        p = pkt.parse(req)
        variable, val, t, sig, proof = (
            p.variable or b"", p.value, p.t, p.sig, p.ss,
        )
        if sig is None:
            raise ERR_MALFORMED_REQUEST
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        if (
            self._shard_check(variable) == "dual"
            and not self._dual_write_ok(variable, t, val)
        ):
            # The dual window keeps in-flight tails alive (re-acks and
            # certifications of versions this replica already stored);
            # a NEW version must mint at the new owner — the hinted
            # decline re-routes the writer in-round.
            self._wrong_shard(variable, stale=True)

        # Writer authentication, exactly as the sign phase does it.
        issuer = sigmod.issuer(sig, self.crypt.keyring)
        tbs = pkt.tbs(req)
        with trace.span(
            "server.verify_batch",
            attrs={"batch_size": 1, "kind": "writer_sig"},
        ):
            sigmod.verify_with_certificate(tbs, sig, issuer)
        signs = self._signs_for(variable)
        if signs:
            # Quorum-certificate check: sign-seat holders only.  A
            # storage-plane node's distance-0 view holds no CERT clique
            # to count against (it never ran this check in the legacy
            # split either — write admission there rested on the
            # collective signature).  Commit still requires 2f+1 clique
            # acks, every one of which DID enforce the writer's quorum
            # certificate, and a pending record on the write plane
            # carries no authority until certified.
            if sig.cert:
                try:
                    for c in certmod.parse(sig.cert):
                        if c.id == issuer.id:
                            issuer = self._present(c)
                            break
                except Exception:
                    # Unparsable embedded chain: keep the presented
                    # issuer; the qcert check below is the authority.
                    pass
            self._check_quorum_certificate(issuer)

        rdata = None
        try:
            rdata = self.storage.read(variable, 0)
        except ERR_NOT_FOUND:
            pass

        inherit = None
        echo = False  # exact stored <t, value> re-ack
        rp = pkt.parse(rdata) if rdata is not None else None
        if rp is not None:
            # TPA gate first, as in the sign phase: the client's auth
            # proof rides the ss slot of the request.
            if rp.auth is not None:
                if proof is None:
                    raise ERR_AUTHENTICATION_FAILURE
                try:
                    self.crypt.collective.verify(
                        variable,
                        proof,
                        qm.choose_quorum_for(self.qs, variable, qm.AUTH),
                        self.crypt.keyring,
                        use_cache=False,
                    )
                except Exception:
                    raise ERR_AUTHENTICATION_FAILURE from None
            if t == rp.t and val == rp.value:
                echo = True  # idempotent retry, write-once included
            elif rp.t == MAX_UINT64:
                raise ERR_NO_MORE_WRITE
            elif t <= rp.t:
                # Stale optimistic timestamp: decline with the hint.
                metrics.incr("server.write_sign.decline")
                return pkt.serialize_ws_ack(decline_t=rp.t)
            if not echo:
                # TOFU, from the write path (reference: server.go:329-
                # 337) — against the latest CERTIFIED owner only.
                prev_sig = self._tofu_prev_sig(variable, rp)
                if prev_sig is not None:
                    new_issuer = sigmod.issuer(sig, self.crypt.keyring)
                    prev_issuer = sigmod.issuer(
                        prev_sig, self.crypt.keyring
                    )
                    if (
                        prev_issuer.id != new_issuer.id
                        and prev_issuer.uid != new_issuer.uid
                    ):
                        raise ERR_PERMISSION_DENIED
            inherit = rp.auth

        share_bytes = b""
        pending_data = None
        if signs:
            tbss = pkt.tbss(req)
            share = self.crypt.collective.sign(self.crypt.signer, tbss)
            share_bytes = pkt.serialize_signature(share)
            pending_data = share.data

        # Persist as commit-pending: partial ss (our own share when we
        # hold a sign seat, an empty marker otherwise), completed=False.
        # Never downgrade a certified record: an echo of a <t, value>
        # the back-fill already completed keeps the completed bytes.
        if not (echo and rp.ss is not None and rp.ss.completed):
            pending = pkt.SignaturePacket(
                type=pkt.SIGNATURE_TYPE_NATIVE,
                version=1,
                completed=False,
                data=pending_data,
            )
            stored = pkt.serialize(variable, val, t, sig, pending, inherit)
            self._persist(variable, t, stored)
        metrics.incr("server.write_sign.ok")
        return pkt.serialize_ws_ack(share=share_bytes)

    def _tofu_prev_sig(self, variable: bytes, rp) -> pkt.SignaturePacket | None:
        """The writer signature that currently OWNS ``variable`` for
        the TOFU check: the latest CERTIFIED record's.  Commit-pending
        and sign-phase residue never grants ownership — any
        quorum-certificate-valid writer can plant residue, so
        ownership-by-residue would let a failed racer (or a deliberate
        squatter) lock the real owner out of its own variable.  None =
        no certified ownership established yet (TOFU vacuous, exactly
        like a fresh variable)."""
        if rp.sig is not None and rp.ss is not None and rp.ss.completed:
            return rp.sig
        for v in self._versions_below(variable, rp.t):
            try:
                cp = pkt.parse(self.storage.read(variable, v))
            except Exception:
                continue  # torn/alien bytes here: keep scanning older
            if cp.ss is not None and cp.ss.completed:
                return cp.sig
        return None

    def _stale_version_upgrade(
        self, variable: bytes, val, t: int, out: bytes
    ) -> bytes | None:
        """Admission for a write BELOW the latest stored version.

        Allowed only as the in-place certification of a commit-pending
        version this replica already admitted: the stored version at
        ``t`` must exist with the SAME value.  Returns the bytes to
        persist at version ``t``, or ``None`` for an idempotent no-op
        (already certified, or superseded by a newer COMPLETED version
        — upgrading under one would make this replica's completed
        sequence go back in time, the §8 monotonicity invariant).
        Anything else is the plain stale write it always was."""
        try:
            vt = self.storage.read(variable, t)
        except ERR_NOT_FOUND:
            raise ERR_BAD_TIMESTAMP from None
        vp = pkt.parse(vt)
        if vp.value != val:
            raise ERR_BAD_TIMESTAMP
        if vp.ss is not None and vp.ss.completed:
            return None  # already certified at t
        for v in sorted(self._versions_above(variable, t), reverse=True):
            try:
                cp = pkt.parse(self.storage.read(variable, v))
            except ERR_NOT_FOUND:
                continue
            if cp.ss is not None and cp.ss.completed:
                return None  # superseded: a newer certified version rules
        metrics.incr("server.write.upgrade")
        if vp.auth is not None:
            p = pkt.parse(out)
            return pkt.serialize(variable, val, t, p.sig, p.ss, vp.auth)
        return out

    def _versions_above(self, variable: bytes, t: int) -> list[int]:
        versions = getattr(self.storage, "versions", None)
        if versions is None:
            return []
        try:
            return [v for v in versions(variable) if v > t]
        except Exception:
            return []

    def _revoke_signers(self, signers1: list[int], signers2: list[int]) -> bool:
        """Revoke every id present in both signer sets; broadcast the
        revocation list when anyone fell (reference: server.go:354-373)."""
        both = set(signers1) & set(signers2)
        revoked = False
        for sid in both:
            node = self.crypt.keyring.get(sid)
            if node is None:
                node = Ref(sid)
            self.self_node.revoke(node)
            vcache.invalidate_signer(sid)
            revoked = True
            metrics.incr("server.revocations")
        if revoked:
            rl = self.self_node.serialize_revoked()
            if rl:
                self.tr.multicast(
                    tp.NOTIFY, self.self_node.get_peers(), rl, None
                )
        return revoked

    # -- TPA (reference: server.go:375-448) -------------------------------

    def _set_auth(self, req: bytes, peer, sender) -> bytes | None:
        p = pkt.parse(req)
        variable = p.variable or b""
        if p.sig is None or p.auth is None or p.t != 0:
            raise ERR_MALFORMED_REQUEST
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        if self._shard_check(variable) == "dual":
            self._wrong_shard(variable, stale=True)
        # Do NOT verify the signature here — it is kept with the auth
        # data for future use (reference: server.go:385).
        try:
            rdata = self.storage.read(variable, 0)
            if pkt.parse(rdata).t != 0:
                raise ERR_EXIST  # can't overwrite the password
        except ERR_NOT_FOUND:
            pass
        self._persist(variable, 0, req)
        return None

    #: Bounds on the per-variable AuthServer map: hard LRU cap plus an
    #: idle TTL (entries idle longer are evicted opportunistically on
    #: the next auth request).  Attempt counters survive eviction in
    #: ``_auth_attempts`` (itself LRU-capped — 64k ints, not sessions).
    AUTH_SESSIONS_MAX = 4096
    AUTH_IDLE_TTL = 3600.0
    AUTH_ATTEMPTS_MAX = 65536

    def _spill_attempts_locked(self, var: bytes, attempts: int) -> None:
        """Fold a retired/orphaned AuthServer's brute-force counter into
        the LRU-capped ``_auth_attempts`` spill map (never decreasing);
        caller holds ``_auth_lock``."""
        if attempts > self._auth_attempts.get(var, 0):
            self._auth_attempts[var] = attempts
            self._auth_attempts.move_to_end(var)
            while len(self._auth_attempts) > self.AUTH_ATTEMPTS_MAX:
                self._auth_attempts.popitem(last=False)

    def _auth_evict_locked(self, now: float) -> None:
        """Evict idle/overflow AuthServers, preserving their attempt
        counters; caller holds ``_auth_lock``."""

        def retire(var: bytes, srv) -> None:
            self._auth_used.pop(var, None)
            self._spill_attempts_locked(var, srv.attempts)

        for var in [
            v
            for v, used in self._auth_used.items()
            if now - used > self.AUTH_IDLE_TTL
        ]:
            retire(var, self._auth.pop(var))
        while len(self._auth) > self.AUTH_SESSIONS_MAX:
            var, srv = self._auth.popitem(last=False)
            retire(var, srv)

    def _authenticate(self, req: bytes, peer, sender) -> bytes:
        phase, variable, adata = pkt.parse_auth_request(req)
        variable = variable or b""
        now = time.monotonic()
        with self._auth_lock:
            self._auth_evict_locked(now)
            a = self._auth.get(variable)
            if a is not None:
                self._auth.move_to_end(variable)
                self._auth_used[variable] = now
        if a is None:
            try:
                rdata = self.storage.read(variable, 0)
            except ERR_NOT_FOUND:
                raise ERR_NO_AUTHENTICATION_DATA from None
            rauth = pkt.parse(rdata).auth
            if rauth is None:
                raise ERR_NO_AUTHENTICATION_DATA
            # Pre-sign our collective-signature share now; it is only
            # released when all auth phases succeed
            # (reference: server.go:425-434).
            share = self.crypt.collective.sign(self.crypt.signer, variable)
            proof = pkt.serialize_signature(share)
            a = authmod.AuthServer(rauth, proof, device=self.device)
            # Two racing first requests may both construct; exactly one
            # instance wins so per-session DH state never splits across
            # copies.
            with self._auth_lock:
                a = self._auth.setdefault(variable, a)
                self._auth.move_to_end(variable)
                self._auth_used[variable] = now
                # An evicted variable's brute-force penalty carries over.
                carried = self._auth_attempts.pop(variable, 0)
                if carried > a.attempts:
                    a.attempts = carried
        # Unlike the reference (server.go:441-447, which deletes the
        # AuthServer on done *and* on error), the AuthServer stays in
        # the map while warm: the anti-brute-force counter must span
        # client sessions or repeated wrong-password runs would each
        # start from attempts=0, and a concurrent client mid-handshake
        # must not lose its per-session DH state.  Per-session state is
        # LRU-bounded inside AuthServer; the map itself is bounded by
        # ``_auth_evict_locked`` with counters durable across eviction.
        try:
            res, done = a.make_response(
                phase, adata or b"", session=(peer or sender).id
            )
        except ERR_TOO_MANY_ATTEMPTS:
            log.warning(
                "server [%s]: auth: too many attempts from %s",
                self.self_node.name,
                getattr(peer or sender, "name", "?"),
            )
            raise
        finally:
            # ``a`` was used outside the lock; a concurrent eviction may
            # have retired it mid-handshake, in which case any attempt
            # increments made here would vanish.  Fold
            # them back into whatever now owns the variable's counter.
            self._auth_fold_attempts(variable, a)
        if done:
            # Successful login clears the penalty — on the handler's
            # instance AND on whatever the map holds now (they can
            # differ after a concurrent eviction + re-create).
            a.reset_attempts()
            with self._auth_lock:
                cur = self._auth.get(variable)
                if cur is not None:
                    cur.reset_attempts()
                self._auth_attempts.pop(variable, None)
        return res

    def _auth_fold_attempts(self, variable: bytes, a) -> None:
        """Carry ``a``'s brute-force counter forward if ``a`` is no
        longer the map's instance for ``variable`` (evicted or replaced
        while an in-flight handler held it outside ``_auth_lock``)."""
        with self._auth_lock:
            cur = self._auth.get(variable)
            if cur is a:
                return
            if cur is not None:
                cur.attempts = max(cur.attempts, a.attempts)
            else:
                self._spill_attempts_locked(variable, a.attempts)

    # -- enrollment (reference: server.go:450-514) ------------------------

    def _register(self, req: bytes, peer, sender) -> bytes | None:
        p = pkt.parse(req)
        variable, value, t, sig, ss = p.variable or b"", p.value, p.t, p.sig, p.ss
        if sig is None or ss is None:
            raise ERR_MALFORMED_REQUEST
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        if self._shard_check(variable) == "dual":
            self._wrong_shard(variable, stale=True)

        issuer = sigmod.issuer(sig, self.crypt.keyring)
        tbs = pkt.tbs(req)
        sigmod.verify_with_certificate(tbs, sig, issuer)

        # The proof: a collective signature over the uid variable —
        # auth-proof shaped, so the verify memo is bypassed.
        self.crypt.collective.verify(
            variable,
            ss,
            qm.choose_quorum_for(self.qs, variable, qm.AUTH),
            self.crypt.keyring,
            use_cache=False,
        )

        ret = None
        certs = certmod.parse(value or b"")
        if certs:
            c = certs[0]  # take the first one only
            if c.uid.encode() != variable:
                raise ERR_INVALID_USER_ID
            certmod.sign_certificate(c, self.crypt.signer.key)
            ret = c.serialize()

        # Persist to settle the auth-setup process, inheriting any
        # stored auth params (reference: server.go:497-513).
        rauth = None
        try:
            rdata = self.storage.read(variable, 0)
            rauth = pkt.parse(rdata).auth
        except ERR_NOT_FOUND:
            pass
        stored = pkt.serialize(variable, value, t, sig, ss, rauth)
        self._persist(variable, t, stored)
        return ret

    # -- distributed crypto (reference: server.go:516-541) ----------------

    def _distribute(self, req: bytes, peer, sender) -> bytes | None:
        p = pkt.parse(req)
        self.storage.write(
            HIDDEN_PREFIX + (p.variable or b""), 0, p.value or b""
        )
        return None

    def _dist_sign(self, req: bytes, peer, sender) -> bytes | None:
        p = pkt.parse(req)
        params = self.storage.read(HIDDEN_PREFIX + (p.variable or b""), 0)
        return self.threshold.sign(
            params, p.value, (peer or sender).id, self.self_node.id
        )

    # -- revocation (reference: server.go:543-560) ------------------------

    def _revoke(self, req: bytes, peer, sender) -> bytes | None:
        nodes = certmod.parse(req)
        for n in nodes:
            if peer is not None and n.id == peer.id:
                self.self_node.revoke(n)
                vcache.invalidate_signer(n.id)
        return None

    def _notify(self, req: bytes, peer, sender) -> bytes | None:
        return None  # no-op, as in the reference

    # -- anti-entropy (no reference analog; sync/) -------------------------

    #: Bounds on one SYNC_PULL response — record count AND bytes (the
    #: native backend stores multi-MB values, so a count cap alone
    #: still allowed multi-GB replies).  A puller missing more simply
    #: re-pulls next round.
    SYNC_PULL_MAX = 8192
    SYNC_PULL_MAX_BYTES = 32 << 20

    def _require_sync_peer(self, peer) -> None:
        """Sync serves keyring-known peers only.

        Defense in depth, NOT the confidentiality boundary: open Join
        enrollment registers first-contact certificates (the web-of-
        trust model), so keyring membership is attacker-satisfiable.
        Confidentiality comes from the plane's content rule instead —
        TPA-protected records never enter digests or pulls at all
        (sync/digest.py ``latest_completed``); everything served here
        is what an anonymous quorum READ would serve anyway."""
        if peer is None:
            raise ERR_PERMISSION_DENIED

    def _sync_digest(self, req: bytes, peer, sender) -> bytes:
        """Serve the keyspace digest tree (bucket → rolling hash over
        completed records)."""
        self._require_sync_peer(peer)
        return self._sync_tree().serialize()

    def _sync_pull(self, req: bytes, peer, sender) -> bytes:
        """Stream the latest completed record of every variable in the
        requested buckets.  The puller re-runs full admission on each —
        nothing served here carries authority."""
        from bftkv_tpu_torch.sync.digest import latest_completed

        self._require_sync_peer(peer)
        tree = self._sync_tree()
        records: list[bytes] = []
        total = 0
        for b in pkt.parse_bucket_ids(req):
            for variable in tree.bucket_variables(b):
                if (
                    len(records) >= self.SYNC_PULL_MAX
                    or total >= self.SYNC_PULL_MAX_BYTES
                ):
                    break
                rec = latest_completed(self.storage, variable)
                if rec is None:
                    continue
                raw = rec[1]
                if len(raw) > self.SYNC_PULL_MAX_BYTES:
                    # An oversized record would blow the puller's reply
                    # cap and be discarded wholesale — re-shipping it
                    # every round would be a convergence livelock, so
                    # it simply never syncs (read-repair still covers
                    # it, like everything did in the reference).
                    metrics.incr("server.sync_pull.oversized")
                    continue
                records.append(raw)
                total += len(raw)
        metrics.incr("server.sync_pull.records", len(records))
        return pkt.serialize_list(records)

    # -- batch pipeline (no reference analog; see transport command doc) --

    def _batch_time(self, req: bytes, peer, sender) -> bytes:
        """B ``time`` requests in one round trip."""
        results: list[tuple[str | None, bytes]] = []
        for variable in pkt.parse_list(req):
            try:
                results.append((None, self._time(variable, peer, sender)))
            except Exception as e:
                results.append((_errstr(e), b""))
        return pkt.serialize_results(results)

    def _batch_read(self, req: bytes, peer, sender) -> bytes:
        """B ``read`` requests in one round trip.  An ok item with an
        empty payload means "no data" — the client buckets it at t=0
        exactly like an empty single-read response."""
        results: list[tuple[str | None, bytes]] = []
        for r in pkt.parse_list(req):
            try:
                p = pkt.parse(r)
                raw = self._read_item(
                    p.variable or b"", p.ss, certified_only=(p.t == 1)
                )
                results.append((None, raw or b""))
            except Exception as e:
                results.append((_errstr(e), b""))
        return pkt.serialize_results(results)

    def _batch_sign(self, req: bytes, peer, sender) -> bytes:
        """B ``sign`` requests in one round trip: writer-signature
        verification and share issuance each run as ONE device batch;
        the per-variable checks run sequentially in item order with
        persist-as-you-go, so intra-batch conflicts hit exactly the
        single-``sign`` equivocation path."""
        with metrics.timer("server.batch_sign.handler"):
            return self._batch_sign_inner(req, peer, sender)

    def _batch_sign_inner(self, req: bytes, peer, sender) -> bytes:
        from bftkv_tpu_torch.ops import dispatch

        reqs = pkt.parse_list(req)
        n = len(reqs)
        results: list[tuple[str | None, bytes] | None] = [None] * n
        parsed: list[tuple | None] = [None] * n  # (p, issuer, tbs)
        vitems: list = []
        vidx: list[int] = []
        vmeta: list[tuple] = []  # (issuer, tbs, sig_bytes) per vitem

        # Embedded certificates are FRAME-level: any item's embedded
        # cert resolves signers of every item in the batch, and each
        # distinct cert byte string parses exactly once.  (The client
        # batch pipeline embeds its cert only on the first item; the
        # profile showed per-item cert parsing was ~50% of the whole
        # handler's Python time at batch 1024.)  Mirrors the response
        # side's first-share-only embedding.
        packets: list = [None] * n
        frame_embedded: dict[int, object] = {}
        seen_cert_bytes: set[bytes] = set()
        for i, r in enumerate(reqs):
            try:
                p = pkt.parse(r)
                sig = p.sig
                # Harvest embedded certs BEFORE the per-item policy
                # checks: the cert-carrying item may itself be rejected
                # (hidden prefix, malformed), and the client embeds the
                # writer cert on the first item only — its rejection
                # must not strip signer resolution from the whole frame.
                if sig is not None and sig.cert:
                    if sig.cert not in seen_cert_bytes:
                        seen_cert_bytes.add(sig.cert)
                        for c in certmod.parse(sig.cert):
                            frame_embedded.setdefault(c.id, c)
                if sig is None:
                    raise ERR_MALFORMED_REQUEST
                if (p.variable or b"").startswith(HIDDEN_PREFIX):
                    raise ERR_PERMISSION_DENIED
                if self._shard_check(
                    p.variable or b""
                ) == "dual" and not self._dual_write_ok(
                    p.variable or b"", p.t, p.value
                ):
                    self._wrong_shard(p.variable or b"", stale=True)
                packets[i] = p
            except Exception as e:
                results[i] = (_errstr(e), b"")
        rich_cache: dict[int, object] = {}  # presented-cert views, per frame
        for i, r in enumerate(reqs):
            p = packets[i]
            if p is None:
                continue
            try:
                issuer = sig_bytes = None
                for sid, sb in sigmod.parse_entries(p.sig.data):
                    c = self.crypt.keyring.get(sid)
                    fe = frame_embedded.get(sid)
                    if c is None:
                        c = fe
                    elif fe is not None:
                        # Presented cert may carry a richer quorum
                        # certificate; transient view (see _present).
                        c = rich_cache.get(sid)
                        if c is None:
                            rich_cache[sid] = c = self._present(fe)
                    if c is not None:
                        issuer, sig_bytes = c, sb
                        break
                if issuer is None:
                    raise ERR_CERTIFICATE_NOT_FOUND
                if sig_bytes is None:
                    raise ERR_INVALID_SIGNATURE
                tbs = pkt.tbs(r)
                parsed[i] = (p, issuer, r)
                # Verify-memo prefilter: an exact-triple hit skips the
                # device batch (a miss verifies below and memoizes).
                if vcache.enabled() and vcache.get(issuer, tbs, sig_bytes):
                    continue
                vitems.append((tbs, sig_bytes, issuer.public_key))
                vidx.append(i)
                vmeta.append((issuer, tbs, sig_bytes))
            except Exception as e:
                results[i] = (_errstr(e), b"")

        # One device batch for every writer signature in the request.
        if vitems:
            d = dispatch.get()
            with trace.span(
                "server.verify_batch",
                attrs={"batch_size": len(vitems), "kind": "writer_sig"},
            ):
                ok = (
                    d.verify(vitems)
                    if d is not None
                    else self.crypt.collective.verifier.verify_batch(vitems)
                )
            for j, i in enumerate(vidx):
                if not ok[j]:
                    results[i] = (_errstr(ERR_INVALID_SIGNATURE), b"")
                    parsed[i] = None
                elif vcache.enabled():
                    issuer_j, tbs_j, sig_j = vmeta[j]
                    vcache.put(issuer_j, tbs_j, sig_j)

        # Quorum certificate, cached per issuer within the batch
        # (reference: server.go:211-214).
        qcert_ok: dict[int, bool] = {}
        for i in range(n):
            if parsed[i] is None:
                continue
            _p, issuer, _r = parsed[i]
            good = qcert_ok.get(issuer.id)
            if good is None:
                try:
                    self._check_quorum_certificate(issuer)
                    good = True
                except Exception:
                    good = False
                qcert_ok[issuer.id] = good
            if not good:
                results[i] = (_errstr(ERR_INVALID_QUORUM_CERTIFICATE), b"")
                parsed[i] = None

        # Per-variable checks + persist-without-ss, sequentially: each
        # item's check sees the previous item's persisted record.
        tbss_list: list[bytes] = []
        tbss_idx: list[int] = []
        for i in range(n):
            if parsed[i] is None:
                continue
            p, issuer, r = parsed[i]
            variable, val, t, sig, ss = (
                p.variable or b"",
                p.value,
                p.t,
                p.sig,
                p.ss,
            )
            try:
                proof = self._sign_storage_checks(variable, val, t, sig, ss)
            except Exception as e:
                results[i] = (_errstr(e), b"")
                continue
            # Keep stored records self-contained: a mid-join writer's
            # cert rode the frame's carrier item only, but later
            # overwrites resolve prev_issuer from THIS record alone —
            # restore the embedded cert the single-item path would
            # have persisted.  Keyring-resolvable issuers stay lean.
            if not sig.cert and self.crypt.keyring.get(issuer.id) is None:
                sig.cert = issuer.serialize()
            stored = pkt.serialize(variable, val, t, sig, None, proof)
            self._persist(variable, t, stored)
            tbss_list.append(pkt.tbss(r))
            tbss_idx.append(i)

        # One device batch for every collective-signature share.  The
        # certificate is embedded ONCE (first share of the frame), not
        # per item: a client whose keyring lacks this server's cert
        # (mid-join) keeps single-path semantics — combine() merges the
        # embedded cert and every later share of the frame resolves —
        # without B copies of cert bloat per response.
        if tbss_list:
            shares = self.crypt.signer.issue_many(tbss_list, include_cert=False)
            cert_bytes = self.crypt.signer.cert.serialize()
            for k, (share, i) in enumerate(zip(shares, tbss_idx)):
                share.completed = False
                if k == 0:
                    share.cert = cert_bytes
                results[i] = (None, pkt.serialize_signature(share))
                metrics.incr("server.sign.ok")

        return pkt.serialize_results(
            [
                r if r is not None
                else (_errstr(ERR_MALFORMED_REQUEST), b"")
                for r in results
            ]
        )

    def _batch_write(self, req: bytes, peer, sender) -> bytes:
        """B ``write`` requests in one round trip; all collective
        signatures verify in ONE device batch."""
        with metrics.timer("server.batch_write.handler"):
            return self._batch_write_inner(req, peer, sender)

    def _batch_write_inner(self, req: bytes, peer, sender) -> bytes:
        reqs = pkt.parse_list(req)
        n = len(reqs)
        results: list[tuple[str | None, bytes] | None] = [None] * n
        parsed: list[tuple | None] = [None] * n
        jobs: list[tuple[bytes, object]] = []
        jidx: list[int] = []
        # Frame-level embedded-cert harvest, as in _batch_sign: the
        # writer cert rides the first item only, but TOFU issuer
        # resolution in _write_storage_checks needs it for EVERY item
        # of a mid-join writer's overwrite.
        frame_embedded: dict[int, object] = {}
        seen_cert_bytes: set[bytes] = set()
        for i, r in enumerate(reqs):
            try:
                p = pkt.parse(r)
                variable, sig, ss = p.variable or b"", p.sig, p.ss
                if sig is not None and sig.cert:
                    if sig.cert not in seen_cert_bytes:
                        seen_cert_bytes.add(sig.cert)
                        for c in certmod.parse(sig.cert):
                            frame_embedded.setdefault(c.id, c)
                if sig is None or ss is None:
                    raise ERR_MALFORMED_REQUEST
                if variable.startswith(HIDDEN_PREFIX):
                    raise ERR_PERMISSION_DENIED
                if self._shard_check(variable) == "dual" and not (
                    self._dual_write_ok(variable, p.t, p.value)
                ):
                    self._wrong_shard(variable, stale=True)
                parsed[i] = (p, r)
                jobs.append((pkt.tbss(r), ss))
                jidx.append(i)
            except Exception as e:
                results[i] = (_errstr(e), b"")

        if jobs:
            # Every surviving item passed _shard_check, so they all
            # share this replica's shard — one keyed AUTH quorum
            # verifies the whole frame.
            qa = qm.choose_quorum_for(
                self.qs, parsed[jidx[0]][0].variable or b"", qm.AUTH
            )
            with metrics.timer("server.batch_write.verify"), trace.span(
                "server.verify_batch",
                attrs={"batch_size": len(jobs), "kind": "collective"},
            ):
                verrs = self.crypt.collective.verify_many(
                    jobs, qa, self.crypt.keyring
                )
            for j, i in enumerate(jidx):
                if verrs[j] is not None:
                    results[i] = (_errstr(verrs[j]), b"")
                    parsed[i] = None

        persists: list[tuple[bytes, int, bytes]] = []
        ok_idx: list[int] = []
        seen_vars: set[bytes] = set()
        for i in range(n):
            if parsed[i] is None:
                continue
            p, r = parsed[i]
            variable, val, t, sig, ss = (
                p.variable or b"",
                p.value,
                p.t,
                p.sig,
                p.ss,
            )
            if variable in seen_vars and persists:
                # A frame naming one variable twice: the second item's
                # admission gates (monotonicity, equivocation) must see
                # the first item's stored state — flush the deferred
                # batch before checking it.
                self._persist_many(persists)
                persists = []
            seen_vars.add(variable)
            try:
                out = self._write_storage_checks(
                    variable, val, t, sig, ss, r, frame_embedded
                )
            except Exception as e:
                results[i] = (_errstr(e), b"")
                continue
            if out is not None:  # None = idempotent no-op (see checks)
                persists.append((variable, t, out))
            ok_idx.append(i)
        # One durability barrier for the whole admitted frame — the
        # group-commit seam the gateway write coalescer feeds.
        self._persist_many(persists)
        for i in ok_idx:
            metrics.incr("server.write.ok")
            results[i] = (None, b"")

        return pkt.serialize_results(
            [
                r if r is not None
                else (_errstr(ERR_MALFORMED_REQUEST), b"")
                for r in results
            ]
        )

    _handlers = {
        tp.JOIN: "_join",
        tp.LEAVE: "_leave",
        tp.TIME: "_time",
        tp.READ: "_read",
        tp.WRITE: "_write",
        tp.SIGN: "_sign",
        tp.AUTH: "_authenticate",
        tp.SETAUTH: "_set_auth",
        tp.DISTRIBUTE: "_distribute",
        tp.DISTSIGN: "_dist_sign",
        tp.REGISTER: "_register",
        tp.REVOKE: "_revoke",
        tp.NOTIFY: "_notify",
        tp.BATCH_TIME: "_batch_time",
        tp.BATCH_SIGN: "_batch_sign",
        tp.BATCH_WRITE: "_batch_write",
        tp.BATCH_READ: "_batch_read",
        tp.SYNC_DIGEST: "_sync_digest",
        tp.SYNC_PULL: "_sync_pull",
        tp.WRITE_SIGN: "_write_sign",
    }


def _errstr(e) -> str:
    """Wire form of a per-item batch error — same interned-message
    convention as the x-error header (accepts classes and instances)."""
    m = getattr(e, "message", None)
    return m if isinstance(m, str) else "internal error"


def _listen_addr(addr: str) -> str:
    """Certificate addresses look like ``http://host:port`` or
    ``loop://name``; the transport start wants the listen side
    (reference: server.go:49-53 keeps only the port)."""
    return addr.split("://", 1)[-1]
