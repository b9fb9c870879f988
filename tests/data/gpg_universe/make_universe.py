"""Makes the GnuPG key universe under this directory, once, with a local
``gpg`` (2.2 or later).

Three nodes, as in ``tests/test_import_gpg.py``'s ``universe`` fixture
(the reference's ``scripts/setup.sh`` shape): RSA-2048 sign-only keys
without a passphrase; a01 signs rw01's key, rw01 signs a01 and u01, each
signed key exported back into the signee's ring (``trust.sh``'s "both"
mode).  Each node's directory gets the exported ``pubring.gpg`` and
``secring.gpg``.  These are test keys: the secret keys are unprotected
and guard nothing.

    python tests/data/gpg_universe/make_universe.py

The GnuPG homedirs live in a temporary directory and their agents are
stopped before it is removed; only the exported rings are written here.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

UIDS = {
    "a01": "a01 (localhost:5701) <svc@example.com>",
    "rw01": "rw01 (localhost:5601) <svc@example.com>",
    "u01": "u01 <foo@example.com>",
}

#: (signer, signee), in order.
CROSS_SIGNS = (("a01", "rw01"), ("rw01", "a01"), ("rw01", "u01"))


def _gpg(gpg: str, home: str, *args, stdin: bytes | None = None) -> bytes:
    os.makedirs(home, mode=0o700, exist_ok=True)
    return subprocess.run(
        [gpg, "--homedir", home, "--batch", "--no-tty", "--yes",
         "--pinentry-mode", "loopback", "--passphrase", "", *args],
        input=stdin, capture_output=True, check=True,
    ).stdout


def _fpr(gpg: str, home: str) -> str:
    for line in _gpg(gpg, home, "--list-keys", "--with-colons").decode().splitlines():
        if line.startswith("fpr:"):
            return line.split(":")[9]
    raise RuntimeError(f"no fingerprint in {home}")


def make(out: str = HERE) -> None:
    gpg = shutil.which("gpg")
    if gpg is None:
        raise SystemExit("make_universe: gpg not found")
    root = tempfile.mkdtemp(prefix="gpgu-")
    homes = {name: os.path.join(root, "." + name) for name in UIDS}
    try:
        for name, uid in UIDS.items():
            _gpg(gpg, homes[name], "--quick-gen-key", uid, "rsa2048", "sign", "never")
        for signer, signee in CROSS_SIGNS:
            _gpg(gpg, homes[signer], "--import", stdin=_gpg(gpg, homes[signee], "--export"))
            _gpg(gpg, homes[signer], "--quick-sign-key", _fpr(gpg, homes[signee]))
            signed = _gpg(gpg, homes[signer], "--export", _fpr(gpg, homes[signee]))
            _gpg(gpg, homes[signee], "--import", stdin=signed)
        for name, home in homes.items():
            d = os.path.join(out, name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "pubring.gpg"), "wb") as f:
                f.write(_gpg(gpg, home, "--export"))
            with open(os.path.join(d, "secring.gpg"), "wb") as f:
                f.write(_gpg(gpg, home, "--export-secret-key"))
    finally:
        gpgconf = shutil.which("gpgconf")
        for home in homes.values():
            if gpgconf and os.path.isdir(home):
                subprocess.run([gpgconf, "--homedir", home, "--kill", "gpg-agent"],
                               capture_output=True)
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
