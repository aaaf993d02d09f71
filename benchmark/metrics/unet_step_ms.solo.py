"""``unet_step_ms`` of the one-client cells, which report
``images_per_s.solo``: the same reader, ``unet_step_ms.py``."""

from pathlib import Path

from benchmark import harness

read = harness.reader("unet_step_ms", Path(__file__).resolve().parent)
