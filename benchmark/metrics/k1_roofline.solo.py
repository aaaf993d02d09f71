"""``k1_roofline`` of the one-client cells, which report
``images_per_s.solo``: the same reader, ``k1_roofline.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("k1_roofline", Path(__file__).resolve().parent)
