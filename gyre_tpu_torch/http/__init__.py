"""HTTP surface of the port: REST, JSON gateway, gRPC-Web (copies of
gyre_tpu/http/)."""
