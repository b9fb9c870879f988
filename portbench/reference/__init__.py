"""The benchmark's plain reference: what a correct run must have stored and
answered, worked out with the host's integers alone.  It imports nothing of
the system under test."""
