"""The benchmark of the port (``repro_torch``) on the H100: see run.py."""
