"""The benchmark of gyre_tpu_torch: served txt2img through gRPC Generate
(see README.md)."""
