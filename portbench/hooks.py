"""Records each launch of the RNS kernels K1, K2 and K5 during a traced window.

The hooks wrap, from outside the program, the entry points that stage
RNS batches (``ops.rns.verify_e65537_rns_indexed`` and
``ops.rns.power_mod_rns``, which know the live rows, the modulus width
and the exponents; ``ops.ec_rns.scalar_mult_hosts`` and
``ops.ec_rns.scalar_base_mult_hosts``, which know the live points), and
the kernel wrappers they launch through (``ops.cuda_rns.verify_cuda``,
``ops.cuda_rns.pow_cuda`` and ``ops.cuda_ec.scalar_mult_cuda``), which
see each launch.  A launch takes the entry's live rows in order, so the
padding rows (or points) of a bucket are not counted.  A launch outside an entry
point is kept as unmodelled, and the roofline of its kernel then reads
nothing.  Renaming these functions leaves the rooflines empty until the
hooks are pointed at the new names.
"""

from __future__ import annotations

import threading

from portbench.workmodel import Launch

__all__ = ["KernelHooks"]


class _Entry:
    __slots__ = ("kernel", "remaining", "mod_bits", "exp_bits", "keys")

    def __init__(self, kernel, rows, mod_bits, exp_bits, keys):
        self.kernel, self.remaining, self.mod_bits, self.exp_bits, self.keys = (
            kernel, rows, mod_bits, exp_bits, keys)


class KernelHooks:
    def __init__(self):
        self.launches: list[Launch] = []
        self.unmodelled = {"k1": 0, "k2": 0, "k5": 0}
        self._tl = threading.local()
        self._lock = threading.Lock()
        self._saved: list = []

    def _entry(self, fn, make):
        def wrapped(*args, **kwargs):
            outer = getattr(self._tl, "entry", None)
            self._tl.entry = make(*args, **kwargs)
            try:
                return fn(*args, **kwargs)
            finally:
                self._tl.entry = outer
        return wrapped

    def _launch(self, fn, kernel: str, axis: int = 0):
        """``fn`` counted as a launch of ``kernel`` whose first operand
        holds its rows on ``axis``."""
        def wrapped(a, *rest):
            e = getattr(self._tl, "entry", None)
            with self._lock:
                if e is None or e.kernel != kernel:
                    self.unmodelled[kernel] += 1
                else:
                    live = min(int(a.shape[axis]), e.remaining)
                    e.remaining -= live
                    self.launches.append(Launch(kernel, live, e.mod_bits, e.exp_bits, e.keys))
            return fn(a, *rest)
        return wrapped

    def install(self) -> None:
        from bftkv_tpu_torch.ops import cuda_ec, cuda_rns, ec_rns, rns

        def verify_entry(sigs, ems, key_idx, unique_rows, **_kw):
            return _Entry("k1", len(sigs), 2048, 17, len(unique_rows))

        def pow_entry(bases, exps, mods, *, n_bits=1024, **_kw):
            return _Entry("k2", len(mods), n_bits, max((e.bit_length() for e in exps), default=0),
                          len(set(mods)))

        def ec_entry(points, *_a, **_kw):
            return _Entry("k5", len(points), 256, 256, 1)

        for mod, name, wrap in (
            (rns, "verify_e65537_rns_indexed", lambda f: self._entry(f, verify_entry)),
            (rns, "power_mod_rns", lambda f: self._entry(f, pow_entry)),
            (ec_rns, "scalar_mult_hosts", lambda f: self._entry(f, ec_entry)),
            (ec_rns, "scalar_base_mult_hosts", lambda f: self._entry(f, ec_entry)),
            (cuda_rns, "verify_cuda", lambda f: self._launch(f, "k1")),
            (cuda_rns, "pow_cuda", lambda f: self._launch(f, "k2")),
            # K5's residues are (3, 2k+1, T): its points lie on the last axis.
            (cuda_ec, "scalar_mult_cuda", lambda f: self._launch(f, "k5", -1)),
        ):
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrap(orig))

    def remove(self) -> None:
        while self._saved:
            mod, name, orig = self._saved.pop()
            setattr(mod, name, orig)
