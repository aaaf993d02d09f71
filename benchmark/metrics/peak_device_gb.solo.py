"""``peak_device_gb`` of the one-client cells, which report
``images_per_s.solo``: the same reader, ``peak_device_gb.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("peak_device_gb", Path(__file__).resolve().parent)
