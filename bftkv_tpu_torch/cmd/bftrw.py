"""``bftrw`` user CLI — register / read / write / ca / sign / kms / getkey
(counterpart of ``bftkv_tpu/cmd/bftrw.py``).

Capability parity with the reference user tool
(cmd/bftrw/bftrw.go:60-165,188-316):

    bftrw --home keys/u01 register --peers keys/a01 ... --password pw
    bftrw --home keys/u01 write  x [value | -]   [--password pw]
    bftrw --home keys/u01 writeonce x [value | -]
    bftrw --home keys/u01 read   x               [--password pw]
    bftrw --home keys/u01 ca     <caname> --key ca.pkcs8
    bftrw --home keys/u01 sign   <caname> --in tbs.bin --algo rsa --hash sha256
    bftrw --home keys/u01 kms    <caname> --password pw   # random key,
                                                               # stored wrapped
    bftrw --home keys/u01 getkey <caname> <name> --password pw

``ca`` deals a private key to the quorum as threshold shares;
``sign`` threshold-signs arbitrary TBS bytes with it (the reference's
X.509-specific plumbing is left to the caller — the signature bytes are
standard PKCS#1 v1.5 / DSA / ECDSA).  ``kms`` generates a random
256-bit key, stores it under a random name password-protected, and
prints the name (reference: bftrw.go:272-316).

``--device`` (default ``cuda:0``, which raises without CUDA) places the
client's crypto: its collective verifies and threshold work.
"""

from __future__ import annotations

import argparse
import os
import sys

from bftkv_tpu_torch import device as devmod


def _algo(name: str):
    from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo

    return {
        "rsa": ThresholdAlgo.RSA,
        "dsa": ThresholdAlgo.DSA,
        "ecdsa": ThresholdAlgo.ECDSA,
    }[name]


def _load_ca_key(path: str):
    """PKCS#8 (or traditional PEM) private key → framework key object
    (reference: bftrw.go:217-243 readPKCS8)."""
    from cryptography.hazmat.primitives import serialization

    with open(path, "rb") as f:
        data = f.read()
    load = (
        serialization.load_pem_private_key
        if b"-----BEGIN" in data
        else serialization.load_der_private_key
    )
    key = load(data, password=None)
    from cryptography.hazmat.primitives.asymmetric import ec as cec
    from cryptography.hazmat.primitives.asymmetric import rsa as crsa

    if isinstance(key, crsa.RSAPrivateKey):
        from bftkv_tpu_torch.crypto import rsa

        pn = key.private_numbers()
        return rsa.PrivateKey(
            n=pn.public_numbers.n, e=pn.public_numbers.e, d=pn.d, p=pn.p, q=pn.q
        )
    if isinstance(key, cec.EllipticCurvePrivateKey):
        from bftkv_tpu_torch.crypto import ec as ecmod
        from bftkv_tpu_torch.crypto.threshold.ecdsa import ECDSAPrivateKey

        if key.curve.name != "secp256r1":
            raise SystemExit(f"unsupported curve {key.curve.name}")
        return ECDSAPrivateKey(ecmod.P256, key.private_numbers().private_value)
    raise SystemExit(f"unsupported CA key type for {path}")


def _value_arg(v: str | None) -> bytes:
    if v is None or v == "-":
        return sys.stdin.buffer.read()
    return v.encode()


# -- X.509 threshold signing (reference: bftrw.go:211-302) ----------------


def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _der_children(data: bytes) -> list[bytes]:
    """Top-level TLV elements of a DER SEQUENCE body (full encodings)."""
    out, off = [], 0
    while off < len(data):
        start = off
        off += 1  # tag (all tags we meet are single-byte)
        ln = data[off]
        off += 1
        if ln & 0x80:
            nbytes = ln & 0x7F
            ln = int.from_bytes(data[off : off + nbytes], "big")
            off += nbytes
        off += ln
        out.append(data[start:off])
    return out


def threshold_sign_x509(a, caname: str, der: bytes) -> bytes:
    """Re-sign an X.509 template certificate with the threshold CA and
    return the assembled DER (reference: bftrw.go:216-302 — the
    template's TBS is threshold-signed and the certificate rebuilt as
    SEQUENCE{tbs, signatureAlgorithm, BIT STRING}).
    """
    from cryptography import x509
    from cryptography.x509.oid import SignatureAlgorithmOID as OID

    crt = x509.load_der_x509_certificate(der)
    oid = crt.signature_algorithm_oid
    algos = {
        OID.RSA_WITH_SHA256: ("rsa", "sha256"),
        OID.RSA_WITH_SHA384: ("rsa", "sha384"),
        OID.RSA_WITH_SHA512: ("rsa", "sha512"),
        OID.ECDSA_WITH_SHA256: ("ecdsa", "sha256"),
        OID.ECDSA_WITH_SHA384: ("ecdsa", "sha384"),
        OID.ECDSA_WITH_SHA512: ("ecdsa", "sha512"),
    }
    if oid not in algos:
        raise SystemExit(f"unsupported signature algorithm {oid}")
    algo_name, hash_name = algos[oid]

    sig = a.sign(caname, crt.tbs_certificate_bytes, _algo(algo_name), hash_name)
    if algo_name == "ecdsa":
        # Our threshold ECDSA yields raw r||s; X.509 carries DER
        # ECDSA-Sig-Value.
        from cryptography.hazmat.primitives.asymmetric.utils import (
            encode_dss_signature,
        )

        half = len(sig) // 2
        sig = encode_dss_signature(
            int.from_bytes(sig[:half], "big"),
            int.from_bytes(sig[half:], "big"),
        )

    outer = _der_children(der)[0]  # the Certificate SEQUENCE
    hdr = 2 if outer[1] < 0x80 else 2 + (outer[1] & 0x7F)
    tbs_b, sigalg_b, _old_sig = _der_children(outer[hdr:])
    bitstring = b"\x03" + _der_len(len(sig) + 1) + b"\x00" + sig
    body = tbs_b + sigalg_b + bitstring
    return b"\x30" + _der_len(len(body)) + body


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bftkv user tool")
    ap.add_argument("--home", required=True)
    ap.add_argument("--no-join", action="store_true",
                    help="skip the joining crawl (offline commands)")
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="device of the client's crypto: cuda:N (default "
                         "cuda:0, which raises without CUDA) or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("register")
    p.add_argument("--peers", nargs="+", required=True,
                   help="server home dirs to trust")
    p.add_argument("--password", required=True)

    for name in ("read", "write", "writeonce"):
        p = sub.add_parser(name)
        p.add_argument("variable")
        if name != "read":
            p.add_argument("value", nargs="?")
        p.add_argument("--password", default="")

    p = sub.add_parser("writemany")
    p.add_argument("--file", default="-",
                   help="lines of variable=value (default stdin); batched "
                        "through the write_many pipeline")

    p = sub.add_parser("readmany")
    p.add_argument("variables", nargs="+")

    p = sub.add_parser("ca")
    p.add_argument("caname")
    p.add_argument("--key", required=True, help="PKCS#8 private key file")

    p = sub.add_parser("sign")
    p.add_argument("caname")
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--algo", choices=["rsa", "dsa", "ecdsa"], default="rsa")
    p.add_argument("--hash", dest="hash_name", default="sha256")
    p.add_argument("--out", default="", help="signature output (default stdout)")

    p = sub.add_parser("signx509")
    p.add_argument("caname")
    p.add_argument("--cert", required=True,
                   help="template certificate (PEM or DER); its TBS is "
                        "threshold-signed by the CA")
    p.add_argument("--out", default="", help="output file (default stdout PEM)")
    p.add_argument("--no-store", action="store_true",
                   help="skip storing the cert under its SubjectKeyId")

    p = sub.add_parser("kms")
    p.add_argument("caname")
    p.add_argument("--password", required=True)

    p = sub.add_parser("getkey")
    p.add_argument("caname")
    p.add_argument("name")
    p.add_argument("--password", required=True)

    args = ap.parse_args(argv)

    from bftkv_tpu_torch import api as apimod

    a = apimod.open_client(args.home, join=not args.no_join, device=args.device)

    if args.cmd == "register":
        a.register(args.peers, args.password)
        print(f"registered uid={a.uid}")
    elif args.cmd == "read":
        value = a.read(args.variable.encode(), args.password)
        if value is None:
            print("not found", file=sys.stderr)
            return 1
        sys.stdout.buffer.write(value)
    elif args.cmd in ("write", "writeonce"):
        value = _value_arg(args.value)
        if args.cmd == "write":
            a.write(args.variable.encode(), value, args.password)
        else:
            a.write_once(args.variable.encode(), value, args.password)
        print("ok", file=sys.stderr)
    elif args.cmd == "writemany":
        src = (
            sys.stdin.buffer
            if args.file == "-"
            else open(args.file, "rb")
        )
        items = []
        seen: set[bytes] = set()
        dup_errs: list[str] = []
        with src:
            for line in src.read().splitlines():
                if not line.strip():
                    continue
                var, sep, value = line.partition(b"=")
                if not sep or not var:
                    # A typoed line must not silently write b"" (or an
                    # empty variable name) into the store.
                    dup_errs.append(
                        f"{line.decode(errors='replace')!r}: "
                        "expected variable=value"
                    )
                    continue
                if var in seen:
                    # write_many forbids duplicate variables (they
                    # would equivocate at the same timestamp); report
                    # per line instead of crashing on the ValueError.
                    dup_errs.append(
                        f"{var.decode(errors='replace')}: duplicate in batch"
                    )
                    continue
                seen.add(var)
                items.append((var, value))
        errs = a.write_many(items)
        rc = 1 if dup_errs else 0
        for msg in dup_errs:
            print(msg, file=sys.stderr)
        for (var, _v), err in zip(items, errs):
            if err is not None:
                print(f"{var.decode(errors='replace')}: {err}", file=sys.stderr)
                rc = 1
        print(f"{sum(e is None for e in errs)}/{len(items)} written",
              file=sys.stderr)
        return rc
    elif args.cmd == "readmany":
        got = a.read_many([v.encode() for v in args.variables])
        rc = 0
        for var, res in zip(args.variables, got):
            if isinstance(res, bytes):
                sys.stdout.buffer.write(var.encode() + b"=" + res + b"\n")
            elif res is None:
                # Match the single `read` command: missing is an error,
                # distinct from a stored-but-empty value.
                print(f"{var}: not found", file=sys.stderr)
                rc = 1
            else:
                print(f"{var}: {res}", file=sys.stderr)
                rc = 1
        return rc
    elif args.cmd == "ca":
        key = _load_ca_key(args.key)
        a.distribute(args.caname, key)
        print(f"ca {args.caname}: key distributed")
    elif args.cmd == "sign":
        with open(args.infile, "rb") as f:
            tbs = f.read()
        sig = a.sign(args.caname, tbs, _algo(args.algo), args.hash_name)
        if args.out:
            with open(args.out, "wb") as f:
                f.write(sig)
        else:
            sys.stdout.buffer.write(sig)
    elif args.cmd == "signx509":
        from cryptography import x509 as _x509
        from cryptography.hazmat.primitives import serialization as _ser

        with open(args.cert, "rb") as f:
            data = f.read()
        if b"-----BEGIN" in data:
            data = _x509.load_pem_x509_certificate(data).public_bytes(
                _ser.Encoding.DER
            )
        out_der = threshold_sign_x509(a, args.caname, data)
        crt = _x509.load_der_x509_certificate(out_der)
        if not args.no_store:
            # Register under the SubjectKeyId (reference: bftrw.go:293).
            try:
                ski = crt.extensions.get_extension_for_class(
                    _x509.SubjectKeyIdentifier
                ).value.digest
                a.write(ski, out_der)
            except _x509.ExtensionNotFound:
                print("no SubjectKeyId extension; not stored", file=sys.stderr)
        pem = crt.public_bytes(_ser.Encoding.PEM)
        if args.out:
            with open(args.out, "wb") as f:
                f.write(pem)
        else:
            sys.stdout.buffer.write(pem)
    elif args.cmd == "kms":
        # Random name + random key, stored password-protected
        # (reference: bftrw.go:272-316).
        name = os.urandom(8).hex()
        key = os.urandom(32)
        a.write((args.caname + "/" + name).encode(), key, args.password)
        print(name)
    elif args.cmd == "getkey":
        value = a.read((args.caname + "/" + args.name).encode(), args.password)
        if value is None:
            print("not found", file=sys.stderr)
            return 1
        sys.stdout.buffer.write(value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
