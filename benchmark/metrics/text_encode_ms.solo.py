"""``text_encode_ms`` of the one-client cells, which report
``images_per_s.solo``: the same reader, ``text_encode_ms.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("text_encode_ms", Path(__file__).resolve().parent)
