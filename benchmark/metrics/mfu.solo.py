"""``mfu`` of the one-client cells, which report
``images_per_s.solo``: the same reader, ``mfu.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("mfu", Path(__file__).resolve().parent)
