"""``device_idle`` of the one-client cells, which report
``images_per_s.solo``: the same reader, ``device_idle.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("device_idle", Path(__file__).resolve().parent)
