"""``images_per_s`` of the one-client cells, under a bound of its own:
a lone client's runs spread more than the loaded cells' (the host
paces a batch of one). The same reader, ``images_per_s.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("images_per_s", Path(__file__).resolve().parent)
